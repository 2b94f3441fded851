from .local import LocalTransport, LocalTransportRegistry  # noqa: F401
from .service import (  # noqa: F401
    TransportService,
    complete_fut,
    fut_result,
)
