"""plan_us_per_query.latency: the reading of plan_us_per_query.py, in the cells
that report p95_batch_ms and not qps end to end, where it moves
p95_batch_ms."""

import importlib.util
import os

_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "plan_us_per_query.py")
_spec = importlib.util.spec_from_file_location("metrics.plan_us_per_query_base", _path)
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
