from repro_torch.serve.engine import (EngineHealth, Request,  # noqa: F401
                                      ServeEngine, ServeReport,
                                      SubmitRejected)
from repro_torch.serve.fleet import (FleetRecord, FleetReport,  # noqa: F401
                                     FleetRouter)
from repro_torch.serve.frontend import (ServeFrontend,  # noqa: F401
                                        StreamHandle)
from repro_torch.serve.manager import (FleetSwapEvent,  # noqa: F401
                                       SwapEvent, TicketError, TicketManager,
                                       TicketMismatch, TicketRecord,
                                       load_ticket)
from repro_torch.serve.paging import (BlockPool, PoolError,  # noqa: F401
                                      blocks_needed)
from repro_torch.serve.ticket import (PlanStats,  # noqa: F401
                                     build_decode_plan)
