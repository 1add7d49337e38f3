"""Host C++ of the port: the shard codec and the JPEG decode pipeline."""
