"""The seeded, resumable synthetic token pipeline (``pipeline``), as
``repro/data``."""
