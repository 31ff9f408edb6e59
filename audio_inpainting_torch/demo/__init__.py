"""The live restore API (live.py): an HTTP server over the facade."""
