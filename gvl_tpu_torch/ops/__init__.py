from gvl_tpu_torch.ops.ms_deform_attn import (  # noqa: F401
    ms_deform_attn_1d, ms_deform_attn_1d_bwd_cuda, ms_deform_attn_1d_bwd_ref,
    ms_deform_attn_1d_cuda, ms_deform_attn_1d_ref,
    ms_deform_attn_1d_sampled_values, prep_taps)
from gvl_tpu_torch.ops.ms_deform_attn_banded import (  # noqa: F401
    ms_deform_attn_1d_banded, ms_deform_attn_1d_banded_bwd_cuda,
    ms_deform_attn_1d_banded_bwd_ref, ms_deform_attn_1d_banded_cuda,
    ms_deform_attn_1d_banded_ref)
