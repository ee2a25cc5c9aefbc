"""Tools that explain and reuse the headline run (ports of the repo's
``tools/profile_step.py``, ``tools/ablate_step.py`` and
``tools/report_resident.py``)."""
