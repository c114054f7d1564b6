"""Audio I/O for the PyTorch port: synthetic fixtures, file decode (native
library) and batch ingestion; the pure-NumPy codecs stay in hpfw_tpu.io."""
