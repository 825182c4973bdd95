"""GACT batch engine: the slot loop on the device (device_batch.py),
its call/record types (batch.py) and sequence banks (seqbank.py)."""
