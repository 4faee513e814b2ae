"""Command-line entry points: ``launch.serve`` (LM generation and sketch
serving) and ``launch.train`` (LM training)."""
