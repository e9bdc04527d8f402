"""The port's -noml pipeline at -threads > 1 (the batched tier: batched ME
NNI rounds, partitioned lockstep SPR rounds, the batched ME lengths,
split test and local bootstrap) against the JAX package's, both on the
CPU, the JAX package's half read from its goldens
(tests/torch_thread_runs.py, scripts/make_torch_port_threads_cpu_golden.py).

Tolerance: none.  The Newick must be byte-identical and the SplitCount
equal: at -threads 4 and 12 (N=100 and N=200), under -bionj (which
-threads takes through the batched ME lengths and split test, as the JAX
package does) and with the local bootstrap of 100 resamples (the
supports in the Newick).
"""
import pytest

from torch_thread_runs import check_identical


@pytest.mark.parametrize("name", ["noml", "noml_t12", "bionj", "boot"])
def test_threads_noml_identical_to_jax(tmp_path, name):
    check_identical(name, tmp_path)
