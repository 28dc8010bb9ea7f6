"""GVL in PyTorch for NVIDIA Hopper: the port of `gvl_tpu`.

The module paths mirror `gvl_tpu`'s, and every module's parameters carry the
names of the reference PDVC `state_dict`, so that
`gvl_tpu.train.checkpoint.import_pytorch_state_dict` reads the port's weights
and `gvl_tpu_torch.convert.jax_params_to_state_dict` writes them from JAX
parameters. This package imports torch and never JAX.
"""
