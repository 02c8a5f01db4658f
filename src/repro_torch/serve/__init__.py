from repro_torch.serve.engine import (Request, ServeEngine,  # noqa: F401
                                     ServeReport, SubmitRejected)
from repro_torch.serve.paging import (BlockPool, PoolError,  # noqa: F401
                                      blocks_needed)
