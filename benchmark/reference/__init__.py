"""The plain reference that decides a run's `correct`: seed index,
D-SOFT and GACT in NumPy and plain PyTorch, from the Darwin reference's
semantics, importing nothing of the program under test."""
