"""Host-side models of the port: the FMI with a torch index, the merge."""
