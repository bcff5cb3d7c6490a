from repro_torch.serve.engine import (  # noqa: F401
    POLICIES,
    ContinuousBatchingEngine,
    Request,
)
from repro_torch.serve.speculative import (  # noqa: F401
    SpeculativeConfig,
    spec_pair_supported,
)
