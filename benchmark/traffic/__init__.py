"""Traffic: mixes (``<mix>.json``, the parameters) and the drivers that
run them (``<kind>.py``, named by a mix's ``kind``)."""
