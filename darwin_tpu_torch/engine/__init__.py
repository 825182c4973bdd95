"""GACT batch engines: the slot loop on the device (device_batch.py)
and the host-stepped loop (batch.py, with its aligner in aligner.py and
its rescoring in scoring.py), their call/record types (batch.py) and
sequence banks (seqbank.py)."""
