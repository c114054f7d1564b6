"""Audio fixtures for the PyTorch port (the codecs stay in hpfw_tpu.io)."""
