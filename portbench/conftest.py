"""The end-to-end metric of each kind of traffic that ``tests/small.py``'s
table ``E2E`` does not list, so that the tests that run every cell of
BENCHMARK.json small (``tests/test_portbench_run.py``) run the cells of
these kinds too.  An entry goes once ``small.py`` lists its kind."""

from portbench.tests import small

small.E2E.setdefault("render_env", small.E2E["render"])
