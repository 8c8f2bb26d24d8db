"""Traffic loop kinds, one module each, found by the name a traffic file gives
under "loop" (see vsbench/loop.py)."""
