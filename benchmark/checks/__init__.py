"""The correctness checks, one module a kind, found by a configuration's
``check``: ``checks/<kind>.py`` (see ``check.py`` for what each exports)."""
