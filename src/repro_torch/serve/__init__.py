from repro_torch.serve.engine import (  # noqa: F401
    POLICIES,
    ContinuousBatchingEngine,
    Request,
)
from repro_torch.serve.faults import (  # noqa: F401
    EngineKilled,
    Fault,
    FaultPlan,
)
from repro_torch.serve.recovery import (  # noqa: F401
    JournalState,
    RequestJournal,
    read_journal,
    recovery_requests,
    restore_engine,
    snapshot_engine,
)
from repro_torch.serve.sampling import SamplingParams  # noqa: F401
from repro_torch.serve.speculative import (  # noqa: F401
    SpeculativeConfig,
    spec_pair_supported,
)
from repro_torch.serve.upgrade import (  # noqa: F401
    UPGRADE_STATES,
    UpgradeError,
    UpgradeManager,
    probe_token_agreement,
)
