"""How the port splits work over ranks (``repro/sharding``)."""
