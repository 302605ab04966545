"""Training UI / observability.

Reference: `deeplearning4j-ui-parent/` (28.5k LoC) — StatsListener
(ui-model) collecting per-iteration stats into StatsStorage (in-memory or
file-backed), served by VertxUIServer's train module, with
RemoteUIStatsStorageRouter posting across JVMs.

Same three roles over the standard library's http.server — `StatsListener` ->
`StatsStorage` (in-memory / JSONL file) -> `UIServer` (http.server
dashboard polling JSON endpoints). Remote posting via
`RemoteUIStatsStorageRouter` (urllib POST to a peer UIServer).
Counterpart of ``deeplearning4j_tpu/ui/``; the listener's statistics are
reductions on the parameters' device (``stats.py``).
"""
from .stats import (InMemoryStatsStorage, FileStatsStorage, StatsListener,
                    RemoteUIStatsStorageRouter)
from .server import UIServer

__all__ = ["InMemoryStatsStorage", "FileStatsStorage", "StatsListener",
           "RemoteUIStatsStorageRouter", "UIServer"]
