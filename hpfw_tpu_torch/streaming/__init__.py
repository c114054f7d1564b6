"""Live song identification over audio streams: one stream (session.py) or
many batched per tick (pool.py)."""
