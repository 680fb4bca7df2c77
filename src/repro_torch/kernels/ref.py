"""Plain PyTorch versions of the port's kernels, under the names of the
reference's oracles (``repro/kernels/ref.py``): same signatures, same
sentinels ``(3.4e38, -1)``, same tie rule. They live beside their
kernels; this module only names them."""
from repro_torch.kernels.l2_topk import (  # noqa: F401
    l2_topk_masked_plain as l2_topk_masked_ref,
)
from repro_torch.kernels.pq_adc import (  # noqa: F401
    pq_adc_masked_plain as pq_adc_masked_ref,
)
