from repro_torch.fedsim.async_engine import (AsyncConfig,  # noqa: F401
                                             AsyncSimState, init_async_state)
from repro_torch.fedsim.pretrain import pretrain_to_target, train_centralized  # noqa: F401
from repro_torch.fedsim.simulator import (FlatSimState, SimConfig,  # noqa: F401
                                          SimState, init_flat_state)
from repro_torch.fedsim.sweep import run_scenario  # noqa: F401
