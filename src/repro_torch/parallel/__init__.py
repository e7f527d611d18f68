"""Data parallelism across processes: the logical sharding rules
(``sharding.py``) and the collectives (``collectives.py``)."""
