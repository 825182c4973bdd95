"""Multi-device (parallel/mesh.py, parallel/collectives.py) and
multi-process (parallel/distributed.py) layers of the port."""
