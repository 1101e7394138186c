"""Frozen copies of the measuring arithmetic: peaks and bounds, the
synthetic generator's draws, and the reading of a profiler trace."""
