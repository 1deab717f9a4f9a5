"""PyTorch / CUDA port of the H2-Fed reproduction (the JAX package
``repro`` is the reference it is held against).

The synchronous flat round runs end to end: ``core.scenario.ScenarioSpec``
-> ``fedsim.pretrain_to_target`` -> ``fedsim.run_scenario``, with the RSU
and cloud aggregation and the dual-proximal update in hand-written CUDA
kernels for Hopper (``kernels/csrc``).  Entry points run on ``cuda``
unless given ``device="cpu"``, which runs the kernels' plain versions.
"""
