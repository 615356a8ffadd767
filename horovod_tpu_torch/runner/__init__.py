"""The worker's half of the launcher's planes (the launcher is the
reference's ``hvdrun``)."""
