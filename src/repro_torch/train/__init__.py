"""Training: AdamW with gradient compression (``optimizer``) and the train
and serving steps (``trainstep``), as ``repro.train``."""
