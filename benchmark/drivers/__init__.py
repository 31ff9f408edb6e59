"""The drivers, one per trainer kind, found by a configuration's ``driver``."""
