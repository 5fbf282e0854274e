"""A frozen copy of the program's plain PyTorch code (``neusky_torch`` at
commit e06a0c4: the model, its fields, nets, samplers, shading, losses,
draws, pixel sampler and optimizer), its imports renamed to this package.
The hand-written kernel K1 is replaced by its plain version
(``ops/hashgrid_plain.py``: one ``index_add_`` on a zero table).  It is
the reference: later changes to the program do not change it."""
