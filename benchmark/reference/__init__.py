"""The benchmark's plain reference of the env and of PPO training.

A frozen copy of the port's plain PyTorch twins (``rules``, ``config``,
``prng``, ``fma``, ``noise``, ``state``, ``step``, ``worldgen``,
``render``), with every call into a CUDA kernel replaced by the twin, and
the plain env loop (``env``), policy (``policy``) and learner (``ppo``)
written here.  It imports nothing of the port or of the JAX package: the
port may change under later PRs, and this copy is what it is held to.
The textures are a copy of the port's ``assets/textures.npz``.
"""
