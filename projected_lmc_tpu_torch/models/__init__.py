"""Models of the port (so far the exact LMC multitask GP)."""
