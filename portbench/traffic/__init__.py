"""Traffic kinds: each sets a cell's system up, drives its window and checks it."""
