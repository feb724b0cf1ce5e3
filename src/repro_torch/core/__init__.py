"""Protocol actors, skip-list oracle and collective schedules (pure
Python, copied from the reference package)."""
