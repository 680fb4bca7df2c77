"""Staged query data plane: plan -> fetch waves -> scan.

``core.search.search_pag`` is the orchestrator; the stages live here:

* ``plan``     — ``KeySpace`` / ``FetchPlan`` / APP probe replay
* ``wave``     — ``WaveScheduler``: every storage wave, every clock
* ``scan``     — ``ScanStage``: the masked CUDA kernel launches
* ``prefetch`` — cross-batch prefetch-ahead (handle + predictor)
"""
from repro_torch.dataplane.plan import (  # noqa: F401
    PAYLOAD_CODE,
    PAYLOAD_FLOAT,
    FetchPlan,
    KeySpace,
    app_probe_order,
    probe_orders,
)
from repro_torch.dataplane.prefetch import (  # noqa: F401
    PrefetchHandle,
    predict_probes,
)
from repro_torch.dataplane.scan import (  # noqa: F401
    ID_SENTINEL,
    INF,
    ScanStage,
    dedup_first,
)
from repro_torch.dataplane.wave import (  # noqa: F401
    SRC_CACHE,
    SRC_PREFETCH,
    SRC_STORE,
    WaveResult,
    WaveScheduler,
    resolve_resilient,
)
