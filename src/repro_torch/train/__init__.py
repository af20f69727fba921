"""Training, from the JAX package's ``train/``: the optimizers
(``optimizer.py``), the dense and sparse-embedding recsys train steps
(``train_step.py``) and the checkpoint (``checkpoint.py``).  Parameters are
one flat dict of tensors keyed by the JAX pytree paths (``core/convert.py``),
so rules, checkpoint keys and parity tests see the JAX package's names."""
