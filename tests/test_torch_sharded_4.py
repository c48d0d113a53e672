"""The port's ``ShardedDataflow`` on 4 gloo ranks against the reference's
``ShardedDataflow`` on a 4-device mesh and against the port's
single-device ``Dataflow``, exact, after every tick: SUM and COUNT by
key, a Distinct, a TopK, a delta and a linear join, a Constant that
emits once and a Threshold in one plan. The
reports' ingest mode and census are held to the reference's
(``tests/torch_sharded_suite.py``)."""

from tests.torch_serving import deadline, one_torch_thread  # noqa: F401
from tests.torch_sharded_suite import make_suite

globals().update(make_suite(4, ("ops",)))
