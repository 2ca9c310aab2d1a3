"""Plain PyTorch references of the benchmark's configurations, their work
counts and bounds.  Nothing here imports the program under test."""
