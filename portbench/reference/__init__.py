"""The benchmark's plain reference of the cells' model: the collapsed bound
and its predictive (``bound``), the trainers (``adam``), sampler transitions
replayed from their random slabs (``sampler``, ``slabs``). Plain torch; it
imports nothing of the program."""
