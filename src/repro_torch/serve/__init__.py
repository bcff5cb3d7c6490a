from repro_torch.serve.engine import (  # noqa: F401
    POLICIES,
    ContinuousBatchingEngine,
    Request,
)
