"""Plain PyTorch versions of the port's kernels, under the names of the
reference's oracles (``repro/kernels/ref.py``): same signatures, same
sentinels ``(3.4e38, -1)``, same tie rule. They live beside their
kernels; this module only names them. ``flash_attention_plain`` takes the
model's layout (q [B, Sq, H, D], k/v [B, Sk, KVH, D]) where the
reference's ``flash_attention_ref`` takes [B, H, S, D] with one KV head
per query head. ``flash_attention_bwd_plain`` is the yardstick of the
attention backward kernel, whose reference is the jnp ``custom_vjp``
backward ``repro/models/attention.py:136`` (it has no oracle in
``repro/kernels/ref.py``)."""
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from repro_torch.kernels.l2_topk import (  # noqa: F401
    l2_topk_masked_plain as l2_topk_masked_ref,
)
from repro_torch.kernels.l2_topk import (  # noqa: F401
    l2_topk_plain as l2_topk_ref,
)
from repro_torch.kernels.pq_adc import (  # noqa: F401
    pq_adc_masked_plain as pq_adc_masked_ref,
)
from repro_torch.kernels.pq_adc import (  # noqa: F401
    pq_adc_plain as pq_adc_ref,
)
