"""Roofline terms of the port's cells on one H100 (``analysis``) and their
tables (``report``), from the dry-run's records (``launch/dryrun.py``)."""
