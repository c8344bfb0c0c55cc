"""The port's benchmark harness: one cell run by ``bench/run.py``, its
pieces found by name (``manifest``), the traffic generator
(``traffic``), the weights (``weights``), the system under test
(``port``), the float32 reference (``reference``), the comparison
(``check``), the frozen counts (``counts``) and the trace's reading
(``trace``)."""
