"""Device operations: the octet sweep, the stream probe and their build."""
