"""Training UI: stats collection + storage-backed dashboard server
(counterpart of ``deeplearning4j_tpu/ui/__init__.py``).

Parity surface: reference ``deeplearning4j-ui-parent`` (ui-model stats
listener + play server); see ``ui/stats.py`` and ``ui/server.py``.
"""

from deeplearning4j_tpu_torch.ui.stats import StatsListener
from deeplearning4j_tpu_torch.ui.server import UIServer, dashboard_html
from deeplearning4j_tpu_torch.ui import components  # noqa: F401

__all__ = ["StatsListener", "UIServer", "dashboard_html"]
