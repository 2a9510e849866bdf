"""Worker of tests/test_torch_distributed.py: one of two processes of a
gloo group on 127.0.0.1, each driving two positions of a (2, 2) mesh on
the CPU (the counterpart of tests/_dist_worker.py).

    python tests/torch_dist_worker.py RANK NPROC PORT REF.npy

It checks nd_tpu_torch.parallel.distributed end to end: initialize,
process_info, global_mesh (y across processes, x across each process's
two positions), host_local_slices (each process takes only its rows),
cube_from_process_tiles (the blocks of its own positions, no more), a
cross-process sum, and shard_apply across the process boundary: a 3 x 3
mean (its rows within rtol 1e-6 of nd_tpu's ``convolve`` of the whole
plane, REF.npy, written by the parent test, and bit-equal to the port's
own serial mean) and NLMeans r=2/f=1 (bit-equal to the serial call).
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nd_tpu_torch.ops.conv import convolve  # noqa: E402
from nd_tpu_torch.ops.nlmeans import nlmeans  # noqa: E402
from nd_tpu_torch.parallel import distributed as dist  # noqa: E402
from nd_tpu_torch.parallel import shard_apply  # noqa: E402

GLOBAL_SHAPE = (12, 8, 3)                  # (y, x, time)


def main():
    rank, nproc, port, ref_path = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4])
    cpu = torch.device('cpu')
    dist.initialize('127.0.0.1:' + port, num_processes=nproc,
                    process_id=rank, backend='gloo',
                    local_devices=[cpu, cpu])
    assert dist.process_info() == (rank, nproc, 2), dist.process_info()

    mesh = dist.global_mesh()              # (nproc, 2): y across processes
    assert dict(mesh.shape) == {'y': nproc, 'x': 2}
    sl = dist.host_local_slices(mesh, GLOBAL_SHAPE)
    rows = GLOBAL_SHAPE[0] // nproc
    assert sl == {'y': slice(rank * rows, (rank + 1) * rows),
                  'x': slice(0, 8)}, sl

    # every process synthesizes the same cube but LOADS only its slice
    full = np.arange(np.prod(GLOBAL_SHAPE), dtype=np.float32) \
        .reshape(GLOBAL_SHAPE)
    tile = full[sl['y'], sl['x']]
    assert tile.shape == (rows, 8, 3), tile.shape
    cube = dist.cube_from_process_tiles(tile, mesh, GLOBAL_SHAPE)
    assert cube.shape == GLOBAL_SHAPE
    assert sorted(cube.blocks) == [(rank, 0), (rank, 1)], sorted(cube.blocks)
    assert sum(b.numel() for b in cube.blocks.values()) == tile.size
    try:
        cube.gather()
        raise AssertionError('a process gathered the whole cube')
    except ValueError:
        pass

    # the cross-process reduction
    local = sum((2.0 * b.double() + 1.0).sum() for b in cube.blocks.values())
    got = float(dist.all_reduce_sum(local.reshape(1))[0])
    want = float((2.0 * full.astype(np.float64) + 1.0).sum())
    assert got == want, (got, want)

    # halo exchange across the process boundary: a 3 x 3 mean over the
    # (process, local position) mesh, the y halo sent between processes
    def stencil(x):
        return convolve(x, np.ones((3, 3), np.float32) / 9, axes=(0, 1),
                        mode='reflect')
    plane = dist.cube_from_process_tiles(tile[..., 0], mesh,
                                         GLOBAL_SHAPE[:2])
    out = shard_apply(stencil, plane, mesh, {'y': (0, 1), 'x': (1, 1)},
                      mode='symmetric')
    ref = np.load(ref_path)
    serial = stencil(torch.from_numpy(full[..., 0].copy()))
    assert len(out.addressable_shards) == 2
    for shard in out.addressable_shards:
        np.testing.assert_allclose(shard.data.numpy(), ref[shard.index],
                                   rtol=1e-6, atol=1e-6 * np.abs(ref).max())
        assert torch.equal(shard.data, serial[shard.index])

    # NLMeans r=2/f=1 (halo 3) over the same mesh
    vals = dist.cube_from_process_tiles(tile[..., None] / 100.0, mesh,
                                        GLOBAL_SHAPE + (1,))

    def nlm(x):
        return nlmeans(x, (2, 2, 0), (1, 1, 0), 2.0, 3.0)
    out = shard_apply(nlm, vals, mesh, {'y': (0, 3), 'x': (1, 3)},
                      mode='reflect')
    serial = nlm(torch.from_numpy(full[..., None] / 100.0))
    for shard in out.addressable_shards:
        assert torch.equal(shard.data, serial[shard.index])

    print('WORKER_OK %d %.1f' % (rank, got), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
