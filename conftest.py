"""The one place that sets the port's CPU thread count for every test process.

The tier-1 suite runs six pytest workers on an eight-core host.  torch's
intra-op pool defaults to one thread a core in each worker, and the JAX tests
beside them run XLA's pools too: with more than one thread a worker the
port's CPU frames oversubscribe the cores and run several times slower than
alone.  One thread a worker runs each of them as fast as it runs alone.
pytest loads this file before tests/conftest.py.  A test that starts its own
interpreter (which loads no conftest) sets the count there itself.
"""

import torch

torch.set_num_threads(1)
