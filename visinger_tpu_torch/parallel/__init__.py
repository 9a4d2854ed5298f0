"""Scale-out over ``torch.distributed``: data-parallel training
(``mesh``, ``multihost``) and time-sharded synthesis (``sp``), the
counterparts of the JAX package's ``parallel/``."""
