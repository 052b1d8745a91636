"""Rule modules register themselves on import (``@register``)."""
from repro_torch.analysis.rules import (alloc001, det001, fbk001,  # noqa
                                        grad001, hot001, krn001, sync001)
