from gvl_tpu_torch.ops.ms_deform_attn import (  # noqa: F401
    ms_deform_attn_1d, ms_deform_attn_1d_cuda, ms_deform_attn_1d_ref,
    ms_deform_attn_1d_sampled_values, prep_taps)
