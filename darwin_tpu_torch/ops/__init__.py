"""Kernels: tile DP (dp.py), traceback walkers (traceback.py), span
fetch (tile_fetch.py), score-only SW (swscore.py) and the lab's plane-2
and scan kernels, each with its plain PyTorch version."""
