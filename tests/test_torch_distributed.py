"""Two real processes of nd_tpu_torch.parallel.distributed on the CPU
(the counterpart of tests/test_distributed_multiprocess.py): a gloo
group on 127.0.0.1 and a free port, two mesh positions a process, each
process loading only its slice, a cross-process sum, and halo exchanges
across the process boundary (tests/torch_dist_worker.py). The 3 x 3
mean's rows are held to nd_tpu's ``convolve`` of the whole plane (rtol
1e-6, float32) and to the port's serial call bit for bit.
"""

import os
import socket
import subprocess
import sys

import numpy as np

import jax.numpy as jnp

from nd_tpu.ops.conv import convolve as jconvolve

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, 'torch_dist_worker.py')
TIMEOUT = 120


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_assembly_reduction_and_halo(tmp_path):
    shape = (12, 8, 3)
    full = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    ref = np.asarray(jconvolve(jnp.asarray(full[..., 0]),
                               jnp.ones((3, 3), jnp.float32) / 9,
                               axes=(0, 1), mode='reflect'))
    ref_path = str(tmp_path / 'ref.npy')
    np.save(ref_path, ref)
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(i), '2', port, ref_path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, 'worker %d failed:\n%s' % (i, out)
        assert 'WORKER_OK %d' % i in out, out
    # both workers computed the same global sum
    vals = {line.split()[2] for out in outs
            for line in out.splitlines() if line.startswith('WORKER_OK')}
    assert len(vals) == 1, vals
