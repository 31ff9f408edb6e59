"""The demo: the artifact gallery (app.py) and the live restore API
(live.py), an HTTP server over the facade."""
