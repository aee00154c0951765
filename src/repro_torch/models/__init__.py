"""The language-model substrate in torch: the JAX package's ``models/``
(config, layers, Mamba-2, stacks, the model API, the sharding rules) as
plain functions over a parameter tree, and ``model.LanguageModel``, the
``nn.Module`` that owns one."""
