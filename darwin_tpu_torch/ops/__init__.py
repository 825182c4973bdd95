"""Tile kernels: DP (dp.py), traceback walker (traceback.py) and span
fetch (tile_fetch.py), each with its plain PyTorch version."""
