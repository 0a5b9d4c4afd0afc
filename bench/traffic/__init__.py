"""Traffic generators (``<generator>.py``) and the mixes that parameterise
them (``<traffic>.json``)."""
