"""The JAX package's four ``examples/*.py`` as modules of the port, each
runnable with ``python -m repro_torch.examples.<name>``:

- ``quickstart``       the register file, the fabric's backends, a
                       reconfiguration without a rebuild, and the paper's
                       module chain on the Hamming kernels;
- ``paper_usecase``    the paper's figures from the hardware model, and
                       the data path on the kernels;
- ``elastic_serving``  the shell's lifecycle under an ``ElasticServer``
                       and a ``Manager`` (``--steady-state``: the cached
                       decode fast path);
- ``moe_training``     a ~100M-parameter MoE LM trained by ``TrainLoop``
                       on a shell (``--sharded``: expert parallelism over
                       gloo ranks under a live ``Shell``).

Each takes the JAX script's flags plus ``--device`` (the card unless
``cpu`` is named), prints what the JAX script prints with the port's
names (the ``pallas`` backend is ``CudaBackend``, ``cuda``; the Pallas
kernels are the Hopper kernels), makes its assertions, and has a function
that returns what it printed as a record.
"""
