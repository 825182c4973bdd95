"""Reference layout (genome.py) and seed-position index (seed_table.py)."""
