"""Device ops of the port: the index, the streamed probe and the walk."""
