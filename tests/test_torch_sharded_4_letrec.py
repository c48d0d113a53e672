"""The port's ``ShardedDataflow`` on 4 gloo ranks against the reference's
``ShardedDataflow`` on a 4-device mesh and against the port's
single-device ``Dataflow``, exact, after every tick: a LetRec
(transitive closure) joined with names under a STRING_AGG and a COUNT. The
reports' ingest mode and census are held to the reference's
(``tests/torch_sharded_suite.py``)."""

from tests.torch_serving import deadline, one_torch_thread  # noqa: F401
from tests.torch_sharded_suite import make_suite

globals().update(make_suite(4, ("agg",)))
