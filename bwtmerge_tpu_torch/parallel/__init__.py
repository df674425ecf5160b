"""Host functions of the port's parallel layer (the multi-device paths
join them with ROADMAP A.10)."""
