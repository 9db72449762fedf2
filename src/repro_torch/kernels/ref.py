"""The plain PyTorch versions of the ported kernels under the reference's
names (``repro/kernels/ref.py``). Each is defined beside its kernel; this
module collects them for tests and the card-side checks."""

from repro_torch.kernels.act_quant import act_quant_ref
from repro_torch.kernels.kv4_attention import kv4_decode_attention_ref
from repro_torch.kernels.paged_attention import (
    combine_work_partials, paged_kv4_decode_attention_ref,
    paged_kv4_decode_attention_wq_ref, paged_kv4_decode_partials_ref,
    paged_kv4_partials_ref, paged_kv4_prefill_attention_ref,
    paged_kv4_prefill_attention_wq_ref)
from repro_torch.kernels.w4ax_matmul import (w4a4_matmul_ref, w4a8_matmul_ref,
                                             w4ax_matmul_mixed_ref,
                                             w4ax_matmul_ref)

__all__ = ["act_quant_ref", "w4a4_matmul_ref", "w4a8_matmul_ref",
           "w4ax_matmul_ref", "w4ax_matmul_mixed_ref",
           "paged_kv4_partials_ref",
           "paged_kv4_prefill_attention_wq_ref", "combine_work_partials",
           "kv4_decode_attention_ref", "paged_kv4_decode_attention_ref",
           "paged_kv4_prefill_attention_ref", "paged_kv4_decode_partials_ref",
           "paged_kv4_decode_attention_wq_ref"]
