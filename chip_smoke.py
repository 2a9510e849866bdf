#!/usr/bin/env python3
"""Drive nd_tpu_torch's SAR change paths, its georeferencing path, its
training path, its dated-stack path, its I/O, its tiling, its device
mesh, its Sentinel-2 granule and vector path, its tracing, host
oracles and rendering, its complex, integer and bool payloads and the
four runnable workflows of examples_torch/ once on one CUDA device.

    python3 chip_smoke.py          # from the repository root

Phases (each prints its own line; any failure raises and exits non-zero):

  1. the card (nvidia-smi name and power limit) and the kernel build
     (nvcc, sm_90a) from ``nd_tpu_torch/csrc``;
  2. the benchmark cube: 1024 x 1024 x 12 dual-pol covariance stack
     (y, x, time, [C11, C12.re, C12.im, C22]) float32 from a seed, on
     the card;
  3. every kernel against its plain PyTorch version on the card, at the
     path's shapes: sepconv in both layouts (max abs diff 0: the tiled
     kernel does the plain version's operations in its order), NLMeans
     r=1/f=1, r=2/f=2, r=2/f=1 (rtol 1e-5, atol 1e-6), the round
     kernel's flags and margins bit-equal to its plain version (margins
     compared as int32; k=12 capped and uncapped, k=40 and k=48 capped)
     and the unpack_flags round trip at k=40; and ragged shapes that fill no
     tile: NLMeans (3-D window) at 37 x 53 x 5 x 4, sepconv with outer 4
     at 37 x 53 x 7; the rescan kernel ``mixed_scan`` on gathered rows
     (N in {1, 33, 1088}, k in {2, 12, 48, 56, 200, 300}, float32 and
     float64 input, zero, negative and NaN determinants, the bursty
     column, alpha 1e-12, and 0.5 looks for the unfolded float64
     branch): packed flags bit-equal to the plain version for 'mixed' and
     'float64', mismatch rate <= 1e-5 for 'float32'; the exact mode's
     rescan entry point ``rescan`` (suspects selected on the card from
     margins with NaN, written into the planes) bit-equal to its plain
     version, with the same suspect count;
  4. exact omnibus (alpha 0.99, 9 looks, margin_eps 1e-4): 0
     mismatches against the plain float64 'mixed' scan of the full grid
     (``change_detection_plain``, never a kernel);
  5. ``SARChangePipeline(ml=3, n=1, alpha=0.9).forward``: 0 mismatches
     against the plain path (plain multilook + 'mixed' scan);
  6. the README chain, ``NLMeansFilter(r=2, f=1, sigma=2, h=3)`` then
     ``OmnibusTest(ml=3, alpha=0.01)`` on a Dataset of the cube: NLMeans
     within the tolerance above, the change map with 0 mismatches
     against the plain scan of the same filtered data;
  7. every kernel's launch counter rose during phases 4-6 (the round
     kernel, the rescan kernel, NLMeans and sepconv);
  8. times from CUDA events (median of 7 after 2 warm-up runs) and
     Mpix/s (y*x*time pixels) of each kernel and its plain version and
     of phases 4-6, beside the card's name and power limit; for each
     kernel row its bound (the least time the card could take: bytes at
     3.35 TB/s or f32 operations at 67 TFLOP/s, the larger; the omnibus
     kernels' operations counted from their sources, the round kernel's
     over the steps its flags imply) and its share of it, and for sepconv
     the library yardstick: cuDNN's depthwise convolution of the already
     padded tensor (VALID part only, pad excluded; TF32 off), which the
     port never calls;

and the long-stack path, on a one-year Sentinel-1 stack: 1024 x 1024 x
56 float32 covariance cube (0.94 GB) with a 5x backscatter step half-way
and a bursty column (x = 0) whose backscatter alternates every 3 dates:

  9. the long-stack kernels against their plain versions at the path's
     shapes: the 3-D NLMeans window r=(2,2,1), f=1 (rtol 1e-5, atol
     1e-6), the long-series scan at k=56 and at k=200 (flags and margins
     bit-equal), the three-axis sepconv with Gaussian (sigma 1) and
     boxcar (w 3) taps and the two-axis sepconv on path A's stacked
     (4, y, x, t) multilook input (max abs diff 0);
 10. path A: ``NLMeansFilter(dims=('y','x','time'), r=(2,2,1), f=1,
     sigma=2, h=3)`` then ``OmnibusTest(ml=3, alpha=0.99)`` on a Dataset
     of the stack: NLMeans within the tolerance above of the plain
     version, the change map with 0 mismatches against the plain float64
     'mixed' scan of the plainly multilooked filtered data; the rescan
     kernel on path A's suspect rows bit-equal to its plain version;
 11. path B: ``change_detection_exact`` at k=200 on a 256 x 512 stack
     (0.42 GB): 0 mismatches against the plain 'mixed' scan; the rescan
     kernel on path B's suspect rows bit-equal to its plain version;
 12. path C: ``GaussianFilter(dims=('y','x','time'), sigma=1)`` and
     ``BoxcarFilter(dims=('y','x','time'), w=3)`` on the stack's C11
     DataArray, each with max abs diff 0 to the plain three-axis pass;
     the launch counters of every kernel of each path rose in that path
     (counters reset just before each path and read just after);
 13. times: each long-stack kernel and its plain version, the scan
     kernel beside the round kernel at k=56 on the same input, and
     paths A, B and C against their plain routes (median of 3 after one
     warm-up; a plain route that runs for seconds once), with bounds and
     yardsticks as in phase 8; the scan kernel's GB/s beside its ms; the
     rescan kernel alone on path A's and path B's suspects, its bound
     from the steps its flags imply (float64 operations at 34 TFLOP/s,
     data sheet);
 14. the streaming probe: ``x + 1`` over the bench cube flattened to
     (49152, 1024) float32 (201 MB), staged through shared memory by TMA
     bulk copies; max abs diff 0 to the plain version, GB/s (2 x bytes /
     time) of the kernel and of ``torch.add(x, 1)``, the bandwidth a
     staging kernel reaches, from single calls and from runs of 50
     back-to-back calls between one event pair (the host's share of a
     single call shows in the difference);
 15. the long-tap kernel: ``GaussianFilter(dims=('y','x','time'),
     sigma=16)`` (129 taps) on path C's C11 DataArray, counted (one
     pass per axis, each on ``csrc/sepconv_long.cu``), max abs diff 0 to
     the same passes' plain versions, timed whole and pass by pass
     beside the tiled kernel's long-tap route on the same pass (the
     parent's route); then that route where it still runs, a long axis
     beside a short one (``sepconv2`` with 3 and 129 taps), counted, max
     abs diff 0, timed;
 16. the wide-window kernel: ``NLMeansFilter(dims=('y','x','time'),
     r=(10,10,3), f=3)`` on a 128 x 128 x 56 x 4 slab of the long stack
     (its halo tile of every variable fits no block of the ring kernel:
     ``csrc/nlmeans_wide.cu``), counted, within rtol 1e-5, atol 1e-6 of
     the plain version, timed;

and the georeferencing path (``generate_test_dataset`` cubes, float32;
each phase held against the same port call on the CPU, timed as the
median of 7 CUDA-event single calls after 2 warm-ups with the plan
caches warm, the whole call and its sampling op alone, beside a bound):

 W1. ``Reprojection(crs='epsg:3395')`` of 512 x 512 x 4 (bench.py's
     warp cell): the separable matmul route, with TF32 switched on by
     the caller (the products must not use it; the switch must be back
     after the call); rtol 1e-5, atol 1e-6; bound: bench.py's 12 B a
     pixel against the two products' float32 operations;
 W2. ``Reprojection(crs='epsg:3035')`` (ETRS89-LAEA) of the 1024 x 1024
     x 12 cube with its four C2 variables (201 MB), bilinear and cubic:
     the gather route; rtol 1e-5, atol 1e-6; bound: the cube read once,
     the output and the coordinate grid once; yardstick ``F.grid_sample``
     (bilinear, align_corners=True; other edge and NaN rules);
 W3. ``Resample`` of W2's cube to twice its pixel, 'average' (matmuls)
     and 'med' (sorted footprint windows); rtol 1e-6 (atol 1e-6 for the
     average of values near 0, 0 for the median);
 W4. ``Coregistration(reference=0, upsampling=10)`` of 512 x 512 x 8
     (bench.py's coregister cell): shifts equal to the CPU's, the cube
     within rtol 1e-5, atol 1e-6; bench.py's registration check (known
     band-limited sub-pixel shifts recovered within 0.2 px); bound:
     bench.py's FFT traffic model;
 W5. W2's bilinear result through ``.filter.nlmeans(r=2, f=1, sigma=2,
     h=3).nd.change_omnibus(ml=3)``: 0 change-map mismatches against the
     plain float64 'mixed' scan of the same filtered cube, plainly
     multilooked; the launch counters of NLMeans, sepconv, the round
     kernel and the rescan rose in that chain (reset just before it);

 17. the exact calls' host share: one ``torch.profiler`` window around
     each exact call (phase 4, path A's, path B's): wall ms, device-busy
     ms and share, device events; and that device time over the call's
     CUDA-event time without the profiler (the profiler's own host work
     inflates its wall);

and the training path on the bench cube (each result held against the
same port calls on the CPU):

 T1. ``SARChangePipeline(ml=3, n=1, alpha=0.9, n_classes=2,
     lr=0.05)``, ``init_params(seed=0)``, five ``train_step`` calls on
     the cube; labels: phase 4's change map, any over time, int32, an
     8-pixel outer ring -1 (masked). Losses finite and within rtol 1e-5
     of the CPU's, parameters rtol 1e-4 / atol 1e-6, the first step's
     features rtol 1e-5 / atol 1e-5; one sepconv launch a step and no
     other kernel (counts reset just before, read just after); the
     step's time split into multilook, ``change_features`` and the head
     (loss, gradient, SGD update), ``change_features`` beside its byte
     bound; peak device memory; one step under ``torch.profiler``;
 T2. ``TorchClassifier(hidden=(16,), epochs=150, lr=0.05)`` on a Dataset
     of T1's 7 features as (y, x) variables, labels + 1 (the ring
     becomes 0, unlabelled): at 10 epochs each parameter tensor within
     1e-4 of its largest magnitude (plus 1e-6) of the CPU's from the
     same initial draw, at 150
     epochs predictions equal to the CPU's on at least 99.9% of pixels;
     accuracy; fit and predict times, the fit beside its bound (X read
     twice an epoch, or its operations); no kernel launched; a 10-epoch
     fit under ``torch.profiler``;
 T3. ``save_params``/``load_params`` of T1's parameters and T2's
     ``(w, b)`` list round-trip bit for bit onto the card; a
     ``Checkpointer(max_to_keep=2)`` over three saves keeps steps 1 and
     2, ``latest_step()`` is 2 and ``restore`` is equal.

and the dated stack (the long stack with a time coordinate of 56 dates
at a 6-day revisit from 2023-01-03 and 2% of its samples set to NaN by
the seed):

 S1. the stencil kernel (non-separable kernels) against its plain
     version, max abs diff 0 in every mode (reflect, nearest, mirror,
     wrap, constant with cval 0 and 1.5): a 5 x 5 disk (21 taps) over
     (y, x) of the stacked views S2 and S3 launch and of the bench cube,
     the 27-point Laplacian over (y, x, time) of the long stack's C11,
     the disk in float64 on 256 x 256 x 12 x 4, a random 3 x 4 x 2
     kernel on a ragged 37 x 53 x 7, a 181 x 181 kernel (the direct
     route), and the kernel's edges: n0 not a multiple of the register
     run and below k0, n1 = 1, rows of 1, 11 and 48, four outer slices,
     3 x 3 and 7 x 7 disks, (5, 1, 1), (1, 5, 1), 9 x 9 and 7 x 9
     kernels (9 x 9 past the unrolled builds), float64 through every
     build (4 x 9 past the 32 weights passed by value); a NaN under the disk's zero taps (NaN where the plain
     version has NaN, equal elsewhere); a chunk whose seam cuts the
     whole call's tiles (its rows equal the whole call's); a four-axis
     kernel against the CPU; the disk and the Laplacian timed beside
     their bound and cuDNN's depthwise conv2d/conv3d of the padded
     tensor (TF32 off), which the port never calls, three ways: single
     calls, 50 back-to-back calls per event pair and the kernel's
     device time under torch.profiler;
 S2. ``njobs=4`` against ``njobs=1``, bit for bit, and 4 x a single
     chunk's launches: the disk ConvolutionFilter on the bench cube
     (split along time, halo 0), the Laplacian over (y, x, time) of C11
     (split along y, halo 1), NLMeansFilter(r=2, f=1) on the bench cube;
 S3. ``interpolate_na(dim='time')`` -> ``resample(time='1MS').mean()`` ->
     the disk ConvolutionFilter -> ``OmnibusTest(ml=3, alpha=0.99)`` with
     ``import pandas`` blocked, counted: 0 change-map mismatches against
     the plain float64 'mixed' scan of the same composites, the
     composites within rtol 1e-6, atol 1e-6 of the CPU's on 64 rows;
 S4. ``quantile(0.9)``, ``median``, ``rolling(time=3, center=True)
     .median()``, ``coarsen(time=4).mean()``, ``groupby('time.month')
     .mean()``, ``weighted(w).mean('time')`` of the dated C11 (58.7 M
     elements), each within rtol 1e-6, atol 1e-6 of the CPU's on 64 rows,
     timed;
 S5. ``ds.nd.apply(fn, signature='(time,var)->(time)')`` on the
     composites (the span C11 + C22 over its temporal mean): the vmap
     route ran, and its result equals the same expression on the same
     stacked tensor bit for bit.

and the I/O layer (each result held against the same call on the CPU,
exactly, and timed beside the card's name and power limit):

 I1. the bench cube as the quick start's ``stack.nc`` (C11, C12 as
     complex64, C22, a time coordinate, ``crs``/``transform`` attrs)
     written by ``to_netcdf`` (netCDF classic CDF-2 where h5py is
     missing, as on the card's machine; the writer is printed) and read
     back onto the card by ``open_dataset``: bit-equal, coordinates and
     attrs equal, on the card; write and read MB/s, and the
     host-to-device share of the read;
 I2. the quick start as README.md writes it, from that file:
     ``open_dataset`` -> ``.nd.as_complex()`` -> ``NLMeansFilter(r=2,
     f=1)`` -> ``OmnibusTest(ml=3, alpha=0.01)``, counted: 0 mismatches
     against the plain scan of the same filtered data, the change map
     equal to phase 6's, and the method-style line equal too;
 I3. a 512 x 512 x 12 cut through GeoTIFF (uncompressed strips; deflate
     tiles with a 2x overview), zarr and ENVI (a written big-endian
     ``.img``/``.hdr`` pair), each bit-equal on the card and the CPU,
     with MB/s;
 I4. ``align`` of two 512 x 512 products written as files (the cube
     and a copy offset by 0.37 px): the ``_aligned.nc`` files equal
     ``Reprojection`` of the same products in memory bit for bit; the
     same ``align`` on the CPU within W2's rtol 1e-5, atol 1e-6 (the
     resampling's sums round in another order on the card).

and lazy opens and tiling, from I1's and I3's files:

 O1. ``open_dataset('stack.nc', chunks={})`` reads no variable (a read
     counter on the lazy netCDF reader); a 256 x 256 ``isel`` reads its
     four slabs only, onto the card, bit-equal to the eager open; a
     window of I3's tiled deflate GeoTIFF through
     ``open_rasterio(chunks={})`` equals the eager read;
 O2. bench.py's tile_pipeline configuration: ``generate_test_dataset``
     2048 x 2048 x 4 as float32 -> ``tile(chunks={'y': 512, 'x': 512},
     buffer=1)`` -> ``map_over_tiles(BoxcarFilter(w=3).apply,
     merge=True, max_workers=8)``: the merge bit-equal to the filter of
     the whole cube on the card, the best of 3 in Mpix/s (pixels times
     4 channels, as bench.py counts them), sepconv launched once a tile;
 O3. ``tile('stack.nc', chunks={'y': 256, 'x': 256}, buffer=4)`` from
     the path (its largest read one buffered tile) ->
     ``map_over_tiles`` of the README chain (NLMeans, then the omnibus
     test) -> ``auto_merge``: the filtered cube within NLMeans's
     tolerance of phase 6's (the largest difference printed), the change
     map with 0 mismatches against the plain scan of the merged cube
     (its mismatches against phase 6's map printed); NLMeans, the round
     kernel, sepconv and the rescan launched once a tile;
 O4. a 4096 x 4096 x 12 x 4 float32 cube (3.2 GB; fewer rows, never
     under 1024, where the disk is short) written by ``to_netcdf``, then
     in a process of its own ``tile(path, chunks={'y': 256}, buffer=4,
     max_workers=2)`` and ``map_over_tiles`` of the chain's change map
     (``merge=False, max_workers=2``): 16 change-map tiles, the first
     tile's core equal to the chain on its window read whole, the peak
     RSS (``/proc/<pid>/statm`` sampled from this process every
     millisecond, ``testing.run_sampling_rss``) less than half the
     cube's bytes over its baseline after the imports and one warm tile,
     the pass in MB/s; the files are deleted.

and the device mesh (``nd_tpu_torch.parallel``), a (2, 2) mesh that
names the card four times (a mesh may name a device more than once),
after O1-O4 in their temporary directory:

 P1. ``apply_sharded`` against the unsharded apply on the bench cube's
     Dataset: BoxcarFilter(w=3), GaussianFilter(sigma=1.5), a random
     3 x 3 ConvolutionFilter (the stencil), NLMeansFilter(r=2, f=1,
     sigma=2, h=3); the halo modes reflect (mirror), edge (nearest),
     constant with cval 1.5 and wrap (w=5, 1024 divides the mesh); the
     boxcar, the stencil and NLMeans on a 1023 x 1021 cut that divides
     neither axis; ``shard_apply`` of the multilook. Convolutions max
     abs diff 0, NLMeans within rtol 1e-5, atol 1e-6 (its largest
     difference printed); four times the unsharded call's launches, one
     a block; the halo bytes exchanged; sharded and unsharded times
     (CUDA events, median of 7);
 P2. the README chain sharded: ``apply_sharded(NLMeansFilter(r=2, f=1,
     sigma=2, h=3))`` then ``sharded_change_detection(alpha=0.01, ml=3)``
     on the (2, 2) mesh and on ``get_mesh()`` (1 x 1, the card), counted:
     0 mismatches to the serial ``OmnibusTest(ml=3, alpha=0.01)`` of the
     same filtered cube and to phase 6's map; timed beside the unsharded
     chain;
 P3. path A's 3-D NLMeans, ``NLMeansFilter(dims=('y','x','time'), r=(2,
     2,1), f=1)``, sharded over the whole long stack (not cut), counted:
     within rtol 1e-5, atol 1e-6 of the unsharded apply, timed beside it;
 P4. ``SARChangePipeline.train_step(mesh=...)`` and ``make_sharded_step``
     on the bench cube with T1's labels: loss within rtol 1e-6 and
     parameters within rtol 1e-5 / atol 1e-7 of the one-device step
     (``tests/test_models.py``'s tolerances), one sepconv launch a block
     and no other kernel; three steps, each held the same way; the
     sharded step's time beside the one-device step's;
 P5. two processes on the card (``sys.executable``, ``chip_smoke.p5_worker``,
     300 s for both), a gloo group on 127.0.0.1 (NCCL takes no two ranks
     on one card): ``initialize``, ``global_mesh()`` of (2, 1), each rank
     reads only its half of I1's ``stack.nc`` (``chunks={}`` and an
     ``isel``; the bytes read counted), ``cube_from_process_tiles``, the
     cube's sum through ``all_reduce_sum`` against the whole cube's (rtol
     1e-9), then ``shard_apply`` of the multilook (sepconv) and of NLMeans
     r=2/f=1 with the halo rows sent between the processes through host
     memory: each rank's block equal to the single process's multilook
     (max abs diff 0) and within rtol 1e-5, atol 1e-6 of its NLMeans. A
     failed or timed-out worker fails the phase.

and a Sentinel-2 granule classified on rasterized parcels (the
committed fixture ``tests/data/torch_s2``: an L1C granule of a tenth of
tile T33UUP's extent in seven JPEG 2000 bands, and a parcel shapefile;
no kernel of the port runs on this path, and none may launch):

 J1. ``open_sentinel2_granule`` at 10, 20 and 60 m with the native
     Tier-1 decoder (``nd_tpu_torch/native``, built with g++ at first
     use; its build time printed): every band's sha256 equal to
     ``MANIFEST.json``, on the card; per band the decode time, the
     Tier-1 code-blocks per second and what that rate makes of a full
     10 m band (labelled extrapolated); the native Tier-1 output (vals
     and lastp) bit-equal to the port's Python ``_T1Decoder`` on 10
     seeded code-blocks of every band;
 J2. ``overview_level`` 0 and 1 of the granule at 10 and 20 m, equal to
     ``MANIFEST.json`` at reduce 1 and 2, the grid's resolution and
     first centre scaled;
 J3. ``read_shapefile`` of the parcels and ``rasterize_values`` of their
     ``class`` (fill 0) on the 10 m grid, on the card, bit-equal to the
     CPU route; then 2,000 ``generate_test_polygons`` on the full tile's
     10980 x 10980 10 m grid at T33UUP's origin: per-polygon pixel counts,
     16 windows and the whole raster equal to the CPU route; the time by
     CUDA events and by the host clock, and the device-busy share under
     ``torch.profiler``;
 J4. ``TorchClassifier(hidden=(16,), epochs=150, lr=0.05)`` fitted on the
     four 10 m bands (float32) with J3's labels (0 unlabelled, dropped):
     at 10 epochs its parameters within 1e-4 of each tensor's largest
     magnitude (plus 1e-6) of a CPU fit from the same seed, at 150 epochs
     its predictions of the whole grid on the card equal to the CPU
     fit's on >= 99.9% of pixels; the accuracy on the labelled pixels,
     the fit and predict times.

and, last, the README chain traced, the host C++ oracles, rendering and
the port's last entry points:

 V1. in a child process (``chip_smoke.v1_child``; a process's earlier
     profiler windows can leave a later one without some kernels'
     events): ``tracing.start_device_trace`` (torch.profiler, CPU and
     CUDA activity), then under ``tracing.annotate('readme_chain')`` (a
     ``record_function`` and an NVTX range) the README chain on the bench
     cube, counted, then ``stop_device_trace``. The parent parses the
     Chrome trace: the range is there, it holds every event of the
     NLMeans, sepconv, round and rescan kernels in the trace, as many as
     their counters rose; ``tracing.report()`` has one
     ``NLMeansFilter.apply`` and one ``BoxcarFilter.apply`` span (the
     omnibus test's multilook) and one of each of ``V_SPANS`` (the
     chain's copies and omnibus steps); the change map equals phase 6's (0
     mismatches). Printed: the trace's size, the device-busy share of
     the range, the chain's CUDA-event time without the profiler (median
     of 5), traced (one call) and under a second window (median of 5);
 V2. bench.py's cpu_baseline configuration (the 128 x 128 cut of the
     bench cube; NLMeans r=(1,1,0), f=(1,1,0), sigma 2, h 3; change
     detection alpha 0.99, 9 looks) through the host C++ oracles
     (``native.nlmeans_native``, ``native.change_detection_native``, one
     thread, built with g++ at first use) against the NLMeans kernel
     (rtol 1e-5, atol 1e-6) and the exact mode on the card (0
     mismatches; a mismatching pixel is printed with its margin);
     ``cpu_1core_mpix_s`` as bench.py:1325 computes it (best of 3), with
     the host's CPU model, beside the card's time for the same two calls;
 V3. ``visualize``'s device part of ``to_rgb`` (percentiles, float64
     stretch, uint8, BGR) on the card for phase 6's filtered cube at t = 0
     (C11 / C22 / ratio) and for the change map's count over time, each
     equal to the same call on CPU copies bit for bit, with the bytes that
     cross to the host against the float channels'; the missing optional
     modules are printed (the card's machine has cv2, not imageio), the
     package-level ``to_rgb`` is None exactly where imageio is missing;
     where cv2 imports, ``to_rgb`` of the card's channels (equal to the
     CPU's device part, RGB) and to a PNG, ``render_map`` and
     ``plot_map`` end to end, where it does not, both raise the JAX
     package's ImportError texts; ``write_video`` writes a 12-frame GIF
     where imageio imports and raises ImportError where it does not;
 V4. ``ops.change.change_detection_hybrid`` on a numpy copy of the bench
     cube: a numpy bool map with 0 mismatches to phase 4's, and with
     ``return_device=True`` a CUDA tensor equal to it (counted: two
     launches each of the round and the rescan kernels); one
     ``TorchClassifier.train_step`` (``torch.optim.Adam``) on the bench
     cube as (y*x, 48) samples on the card against the same step on the
     CPU: loss rtol 1e-5, parameters within 1e-4 of each tensor's
     largest magnitude (plus 1e-6).

and the repaired payload faults and the four runnable workflows of
``examples_torch/``, each against the CPU:

 E1. on a 256 x 256 x 12 cut of the bench cube: its C12 as complex64
     and complex128 with 1% NaN real parts, 1% NaN imaginary parts and
     an all-NaN series: ``mean``, ``std``, ``var``, ``sum``, ``median``,
     ``max``, ``min``, ``argmax``, ``argmin``, ``cumsum`` and ``diff``;
     ``round`` of int32, bool and complex payloads, ``argmax``/``argmin``
     of bool and int32 ones, ``clip`` of complex and int32 ones, and
     numpy's promotions (int32 + 1.5, int32 ** 0.5, uint16 * 1e-4, int32 +
     float32, int16 * float32, bool + float32, complex - 1.5 - complex)
     with their dtypes: selections, rounding and element-wise results bit
     for bit (the float64 power within rtol 1e-14: the card's pow rounds
     otherwise), sums within rtol 1e-5, atol 1e-6 (complex64) or rtol
     1e-12 (complex128);
 E2-E5. ``geostationary_disk``, ``out_of_core_mosaic`` (sepconv on every
     tile, counted), ``timeseries_gapfill`` and ``continental_mosaic`` on
     the card at their default sizes (their printed lines equal to the
     CPU run's) and at ``E_REAL``'s sizes (SEVIRI's 3712 x 3712 full disk,
     1024 x 1024 x 12, two 1024 x 1024 x 36 swaths, 2 km), each result
     within rtol 1e-5, atol 1e-6 of a CPU run of the same copy (run in a
     process of its own beside the card's runs, ``e_cpu_child``), the
     wall times on the host clock.

Before the last line it prints one JSON object with every kernel entry
point (name, route, source, replaced TPU kernel, launches in its paths,
max abs error, ms, plain ms, bound ms and what sets it, library ms or
null), then the nvidia-smi line. The last line is ``{"ok": true,
"device": {...}}``. Without a CUDA device, or without the package beside
it, it exits non-zero and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

NY, NX, K = 1024, 1024, 12
KL = 56                     # one year of Sentinel-1 at a 6-day revisit
BNY, BNX, BK = 256, 512, 200
SEED = 0
DEVICE = 'cuda'
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, at 700 W
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores, the same
F64_OPS_PER_S = 34e12       # f64 outside the tensor cores, the same
LOG_OPS = 20                # a float64 log counted as 20 operations
# entry point -> (source, replaced TPU kernel, counting module, counter)
KERNELS = {
    'sepconv': ('nd_tpu_torch/csrc/sepconv.cu',
                'nd_tpu/ops/conv_pallas.py:576', 'conv_cuda', 'launches'),
    'sepconv3': ('nd_tpu_torch/csrc/sepconv.cu',
                 'nd_tpu/ops/conv_pallas.py:117', 'conv_cuda',
                 'launches3'),
    'nlmeans': ('nd_tpu_torch/csrc/nlmeans.cu',
                'nd_tpu/ops/nlmeans_pallas.py:408', 'nlmeans_cuda',
                'launches'),
    'nlmeans_3d': ('nd_tpu_torch/csrc/nlmeans.cu',
                   'nd_tpu/ops/nlmeans_pallas.py:568', 'nlmeans_cuda',
                   'launches_3d'),
    'omnibus': ('nd_tpu_torch/csrc/omnibus.cu',
                'nd_tpu/ops/change_pallas.py:399', 'change_cuda',
                'launches'),
    'omnibus_scan': ('nd_tpu_torch/csrc/omnibus_scan.cu',
                     'nd_tpu/ops/change_scan_pallas.py:421',
                     'change_scan_cuda', 'launches'),
    'omnibus_mixed': ('nd_tpu_torch/csrc/omnibus_mixed.cu',
                      'nd_tpu/ops/change.py:161', 'change_mixed_cuda',
                      'launches'),
    'stream_probe': ('nd_tpu_torch/csrc/stream_probe.cu', 'bench.py:176',
                     'stream_cuda', 'launches'),
    # the tiled sepconv kernel's long-tap route, counted apart: a long
    # axis beside a short one (the reference sends long taps to XLA)
    'sepconv_long': ('nd_tpu_torch/csrc/sepconv.cu', 'nd_tpu/ops/conv.py:567',
                     'conv_cuda', 'launches_long'),
    # kernels of shapes the reference sends to XLA: one long axis, wide
    # NLMeans windows
    'sepconv_long_axis': ('nd_tpu_torch/csrc/sepconv_long.cu',
                          'nd_tpu/ops/conv.py:567', 'conv_cuda',
                          'launches_long_axis'),
    'nlmeans_wide': ('nd_tpu_torch/csrc/nlmeans_wide.cu',
                     'nd_tpu/ops/nlmeans.py:46', 'nlmeans_cuda',
                     'launches_wide'),
    # the reference runs non-separable kernels through XLA's convolution
    # (no Pallas kernel); the port's own stencil
    'stencil': ('nd_tpu_torch/csrc/stencil.cu', 'nd_tpu/ops/conv.py:123',
                'stencil_cuda', 'launches'),
}


def make_cube(ny, nx, k, seed=SEED, step=2.5, burst=False):
    """Synthetic S1 dual-pol C2 covariance cube (f32, PSD per pixel) with
    an abrupt backscatter change (x ``step``) half-way through the
    series; with ``burst`` the column x = 0 alternates its backscatter
    between 1 and 5 every 3 dates (many change points)."""
    rng = np.random.RandomState(seed)
    c11 = np.abs(rng.normal(1.0, 0.25, size=(ny, nx, k))) + 0.3
    c22 = np.abs(rng.normal(1.0, 0.25, size=(ny, nx, k))) + 0.3
    mag = 0.4 * np.sqrt(c11 * c22) * rng.uniform(0, 1, size=(ny, nx, k))
    phase = rng.uniform(0, 2 * np.pi, size=(ny, nx, k))
    c12r = mag * np.cos(phase)
    c12i = mag * np.sin(phase)
    c11[:, :, k // 2:] *= step
    c22[:, :, k // 2:] *= step
    if burst:
        wave = np.where((np.arange(k) // 3) % 2 == 0, 1.0, 5.0)
        c11[:, 0] = wave
        c22[:, 0] = wave
        c12r[:, 0] = 0.05
        c12i[:, 0] = 0.02
    return np.stack([c11, c12r, c12i, c22], axis=-1).astype(np.float32)


def check(ok, *what):
    """Fail the run (an explicit check: asserts vanish under -O)."""
    if not ok:
        raise RuntimeError('chip_smoke check failed: %r' % (what,))


def phase(n, text):
    print('phase %s: %s' % (n, text), flush=True)


def bound(nbytes, ops):
    """(ms, what sets it): the least time the card could take for work
    that moves ``nbytes`` (each input read once, each output written
    once) and does ``ops`` f32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def pass_ops(taps):
    """f32 operations per output of one tap pass, as the kernel and
    its plain version do them: uniform taps are added and scaled once,
    weighted taps multiplied and added."""
    t = np.ravel(np.asarray(taps, np.float64))
    if np.allclose(t, t[0]):
        return len(t) - 1 + int(t[0] != 1.0)
    return 2 * len(t) - 1


def sepconv_bound(x, *taps):
    return bound(2 * x.numel() * x.element_size(),
                 x.numel() * sum(pass_ops(t) for t in taps))


def nlmeans_bound(x, r, f):
    """Per output and unordered offset pair: the squared differences
    over the variables, the three patch passes, the weight (division,
    subtraction, max, product, exp) and the two directions' weighted
    adds."""
    nv = x.shape[3]
    pairs = (int(np.prod([2 * ri + 1 for ri in r])) - 1) // 2
    per_pair = (3 * nv - 1) + 2 * sum(f) + 5 + 2 * (2 * nv + 2)
    npix = x.numel() // nv
    return bound(2 * x.numel() * x.element_size(), npix * pairs * per_pair)


# f32 operations of the omnibus kernels, counted from their sources: each
# add, multiply, division, sqrt, |.|, floor, compare, select and
# int-to-float conversion is one; a NaN-propagating min or max (two NaN
# tests, the add, the min, the select) five; mlog (csrc/mlog.cuh) 25.
MLOG_OPS = 25
ELEM_OPS = 55       # a step's determinant, log|det|, signed conditioning
WINDOW_OPS = 42     # a window's determinant, margin and compare, no log


def scan_bound(x, tabs):
    """The scan kernel's bound: the series read once, the flag planes and
    the margin written once; per pixel the f32 operations of
    csrc/omnibus_scan.cu with each statistic counted once: every step's
    element terms (ELEM_OPS), pass B's suffix sums (7 adds, the window
    length and the threshold test) and, where the global threshold is
    finite, its window statistic (WINDOW_OPS + 4 + MLOG_OPS), and pass
    A's running sums, the next length's threshold (sqrt, the Horner of
    the fitted polynomial, the j = 2..5 immediates, 1/j), the averaged
    window statistic (WINDOW_OPS + 6 + MLOG_OPS), the gated margin and
    the chain's selects."""
    ny, nx, k, _ = x.shape
    finite = int(np.isfinite(np.asarray(tabs['cg_tab'][2:k + 1])).sum())
    thresh = 7 + 2 * (len(tabs['f2_coefs']) - 1) + 3 * len(tabs['f2_small'])
    per_pix = (ELEM_OPS * k + 9 * (k - 1)
               + finite * (WINDOW_OPS + 4 + MLOG_OPS)
               + (k - 1) * (7 + thresh + WINDOW_OPS + 7 + MLOG_OPS + 18))
    out = ny * nx * 4 * ((k + 30) // 31 + 1)
    return bound(x.numel() * x.element_size() + out, ny * nx * per_pix)


def round_bound(x, planes, max_rounds, margins=True):
    """The round kernel's bound: the series read once, the flag planes
    (and the margins) written once; the f32 operations of csrc/omnibus.cu
    over the steps these flags imply (``scan_steps``, at most
    ``max_rounds`` rounds a pixel): once per pixel and step its terms that
    do not depend on the anchor (the determinant, its log and the sign,
    6 + MLOG_OPS; 16 more for the margin's conditioning), per step of a
    round the running sums and the sign parity (6; 2 more with margins),
    per tested step the window statistic (19 + MLOG_OPS; 28 more for its
    margin)."""
    ny, nx, k, _ = x.shape
    steps, tested = scan_steps(planes.reshape(planes.shape[0], -1), k,
                               max_rounds)
    ops = (ny * nx * k * (6 + MLOG_OPS + 16 * margins)
           + steps * (6 + 2 * margins)
           + tested * (19 + MLOG_OPS + 28 * margins))
    out = ny * nx * 4 * (planes.shape[0] + (1 if margins else 0))
    return bound(x.numel() * x.element_size() + out, ops)


def scan_steps(planes, k, max_rounds=None):
    """(steps, tested steps) that the round scan of these rows runs: one
    round from l = 0 and one from every flag p < k-1 (the first
    ``max_rounds`` rounds only, where given), each over t = l .. k-1,
    testing t >= l+1."""
    import torch
    nrows = planes.shape[1]
    flags = torch.cat([((planes[pp][:, None] >> torch.arange(
        min(31, k - 31 * pp), device=planes.device)) & 1) > 0
        for pp in range(planes.shape[0])], 1)                  # (N, k)
    anchors = flags[:, :k - 1]
    if max_rounds is not None:      # flag i (1-based) starts round i
        anchors = anchors & (torch.cumsum(anchors.int(), 1) < max_rounds)
    rest = (k - torch.arange(k - 1, device=planes.device)) * anchors
    rounds = nrows + int(anchors.sum())
    steps = nrows * k + int(rest.sum())
    return steps, steps - rounds


def mixed_bound(rows, planes, margins=0):
    """The rescan kernel's bound: the rows read once and the planes
    written once (and ``margins`` float32 margins read once, where the
    suspects are selected from them); per step the float64 operations of
    the folded test in csrc/omnibus_mixed.cu (|det| converted, its log,
    the log sum; on a tested step the sums and j converted, the window
    determinant, the select, the statistic's products and difference,
    its log and the compare) and the float32 operations of the
    determinant, the four sums and the sign count."""
    k = rows.shape[1]
    steps, tested = scan_steps(planes, k)
    f64 = steps * (2 + LOG_OPS) + tested * (16 + LOG_OPS)
    f32 = steps * 10
    t_bytes = (rows.numel() * rows.element_size()
               + planes.numel() * 4 + margins * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = (f64 / F64_OPS_PER_S + f32 / F32_OPS_PER_S) * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


# ---- W1-W5: the georeferencing path -----------------------------------------

W1_CUBE = {'y': 512, 'x': 512, 'time': 4}       # bench.py's warp cell
W2_CUBE = {'y': 1024, 'x': 1024, 'time': 12}     # the bench cube's size
W4_CUBE = {'y': 512, 'x': 512, 'time': 8}        # bench.py's coregister cell
REG_SIZE = 512                                   # its registration check
W_NAMES = ('C11', 'C12__re', 'C12__im', 'C22')


def on_device(ds, device):
    """A copy of a port Dataset with every tensor on ``device``."""
    import torch
    out = ds.copy(deep=False)
    for table in (out._variables, out._coords):
        for k, var in table.items():
            if isinstance(var.data, torch.Tensor):
                table[k] = type(var)(var.dims, var.data.to(device),
                                     var.attrs)
    return out


def allclose(got, ref, rtol, atol):
    """(ok, max abs diff over the finite pairs): NaN where NaN, +-inf
    where +-inf, the rest within atol + rtol * |ref|."""
    import torch
    got = got.detach().cpu().double()
    ref = ref.detach().cpu().double()
    fin = torch.isfinite(ref)
    same_nonfinite = bool(((got == ref) | (got.isnan() & ref.isnan()))
                          [~fin].all())
    diff = (got - ref).abs()[fin]
    excess = diff - (atol + rtol * ref.abs()[fin])
    top = float(diff.max()) if diff.numel() else 0.0
    return (same_nonfinite and bool((excess <= 0).all())
            and bool(torch.isfinite(got)[fin].all())), top


def hold_datasets(got, ref, rtol, atol, what):
    """Every variable of the card's result against the CPU's."""
    worst = 0.0
    for v in ref.data_vars:
        ok, top = allclose(got[v].data, ref[v].data, rtol, atol)
        check(ok and got[v].dims == ref[v].dims, what, v, top)
        worst = max(worst, top)
    return worst


def fft_model(k, ny, nx, nvars):
    """bench.py's FFT traffic model of a registration (per pixel of one
    time step: the forward rfft2 of f32 into a c64 half-spectrum, its
    axis-0 pass, the cross-power spectrum, the inverse's two passes and
    the argmax), plus the translation of ``nvars`` variables (4 B read
    and 4 B written a pixel, 16 operations a pixel); FLOPs: three 2-D
    transforms at 5 N log2 N, about 10 for the cross-power."""
    hs = (nx // 2 + 1) / nx
    c = 8.0 * hs
    fft_bytes = (4 + c) + 2 * c + 3 * c + 2 * c + (c + 4) + 4
    fft_ops = 3 * 5 * np.log2(ny * nx) + 10
    pix = k * ny * nx
    return bound(pix * (fft_bytes + 8 * nvars),
                 pix * (fft_ops + 16 * nvars))


def run_warp_phases(ndt, dev, card, cuda_ms, reset_counts, read_counts,
                    box_taps):
    """W1-W5: the reprojection and coregistration path at the reference
    benchmark's sizes, each phase held against the same port function
    on the CPU, then the reprojected cube through the change chain.
    Returns the kernel launches of W5's chain."""
    import torch
    import torch.nn.functional as F
    from nd_tpu_torch import warp
    from nd_tpu_torch.ops import conv_cuda
    from nd_tpu_torch.ops.change import change_detection_plain
    from nd_tpu_torch.ops.fft import phase_cross_correlation_batch
    from nd_tpu_torch.ops.interp import (footprint_resample,
                                         map_coordinates, matmul_resample)
    from nd_tpu_torch.testing import generate_test_dataset

    cpu = torch.device('cpu')
    dkey = str(torch.empty(0, device=dev).device)    # the caches' key

    def report(tag, text, call_ms, op_ms, bnd, yard_ms=None):
        line = '%s; call %.3f ms (median of 7 after 2 warm-ups, caches ' \
            'warm), sampling alone %.3f ms | bound %.3f ms (%s), %.1f%% ' \
            'of it' % (text, call_ms, op_ms, bnd[0], bnd[1],
                       100.0 * bnd[0] / op_ms)
        line += ' | no PyTorch yardstick' if yard_ms is None \
            else ' | yardstick %.3f ms' % yard_ms
        phase(tag, line + ' | ' + card)

    def gen(dims):
        card_ds = generate_test_dataset(dims=dims, device=dev).astype(
            'float32')
        return card_ds, on_device(card_ds, cpu)

    def grid_key(ds, out):
        src_t = tuple(warp.get_transform(ds))[:6]
        return (tuple(out.attrs['transform'])[:6],
                (out.sizes['y'], out.sizes['x']), src_t,
                warp.get_crs(ds).to_proj4(), warp.get_crs(out).to_proj4())

    def stacked(ds):
        """The (V*k, y, x) stack the warp samples for this cube."""
        return torch.stack([ds[v].transpose('time', 'y', 'x').data
                            for v in W_NAMES]).reshape(
            -1, ds.sizes['y'], ds.sizes['x']).contiguous()

    # ---- W1: separable warp, EPSG:4326 -> EPSG:3395, the matmul route -----
    # the caller switches TF32 on: the warp's products must not use it
    torch.backends.cuda.matmul.allow_tf32 = True
    w1, w1_cpu = gen(W1_CUBE)
    proj = ndt.Reprojection(crs='epsg:3395')
    out1 = proj.apply(w1)
    ref1 = proj.apply(w1_cpu)
    check(torch.backends.cuda.matmul.allow_tf32, 'TF32 setting restored')
    diff = hold_datasets(out1, ref1, 1e-5, 1e-6, 'W1 matmul warp')
    key1 = grid_key(w1, out1)
    plan = warp._cached_plan(*key1, (W1_CUBE['y'], W1_CUBE['x']),
                             'bilinear', '<f4', dkey)
    check(plan is not None, 'W1 takes the matmul route')
    x1 = stacked(w1)
    call_ms = cuda_ms(lambda: proj.apply(w1))
    op_ms = cuda_ms(lambda: matmul_resample(x1, *plan[:6], float('nan'),
                                            expected=plan[6]))
    B, H, W = x1.shape
    Hd, Wd = plan[0].shape[0], plan[2].shape[0]
    flops = 2 * 2 * B * (H * W * Wd + Hd * H * Wd)    # two products, each
    bnd = bound(12 * B * H * W, flops)                # bench's 12 B/pixel
    report('W1', 'Reprojection(crs=epsg:3395) of %d x %d x %d x 4 float32 '
           '(TF32 on in the caller): %dx%d output, max abs diff %.3g vs '
           'CPU (rtol 1e-5, atol 1e-6)' % (H, W, W1_CUBE['time'], Hd, Wd,
                                          diff), call_ms, op_ms, bnd)
    torch.backends.cuda.matmul.allow_tf32 = False
    del w1, w1_cpu, out1, ref1, x1

    # ---- W2: curvilinear gather, EPSG:4326 -> EPSG:3035 -------------------
    w2, w2_cpu = gen(W2_CUBE)
    out2 = {}
    for method in ('bilinear', 'cubic'):
        rp = ndt.Reprojection(crs='epsg:3035', resampling=method)
        out = rp.apply(w2)
        ref = rp.apply(w2_cpu)
        diff = hold_datasets(out, ref, 1e-5, 1e-6, 'W2 gather ' + method)
        nan_share = float(out['C11'].data.isnan().float().mean())
        out2[method] = out
        del ref
        key2 = grid_key(w2, out)
        rows, cols = warp._cached_grid(*key2, '<f4', dkey)
        x2 = stacked(w2)
        call_ms = cuda_ms(lambda: rp.apply(w2))
        op_ms = cuda_ms(lambda: map_coordinates(x2, rows, cols, method))
        taps = 4 if method == 'bilinear' else 16
        n_out = x2.shape[0] * rows.numel()
        bnd = bound(4 * x2.numel() + 4 * n_out + 8 * rows.numel(),
                    n_out * taps * 4)
        yard_ms = None
        if method == 'bilinear':
            # a yardstick only: grid_sample's edge and NaN semantics
            # differ from the gather's
            H, W = x2.shape[-2:]
            grid = torch.stack([cols / (W - 1) * 2 - 1,
                                rows / (H - 1) * 2 - 1], -1)[None]
            xin = x2[None]
            yard_ms = cuda_ms(lambda: F.grid_sample(
                xin, grid, mode='bilinear', padding_mode='zeros',
                align_corners=True))
        report('W2', 'Reprojection(crs=epsg:3035, resampling=%s) of %d x %d '
               'x %d x 4 float32 (%.0f MB): %s output, %.1f%% NaN (off the '
               'source), max abs diff %.3g vs CPU (rtol 1e-5, atol 1e-6)'
               % (method, W2_CUBE['y'], W2_CUBE['x'], W2_CUBE['time'],
                  x2.numel() * 4 / 1e6, tuple(rows.shape), 100 * nan_share,
                  diff), call_ms, op_ms, bnd, yard_ms)
        del x2

    # ---- W3: footprint statistics, twice the source pixel -------------------
    res = tuple(2 * r for r in warp.get_resolution(w2))
    for method, rtol, atol in (('average', 1e-6, 1e-6), ('med', 1e-6, 0)):
        rs = ndt.Resample(res=res, resampling=method)
        out = rs.apply(w2)
        ref = rs.apply(w2_cpu)
        diff = hold_datasets(out, ref, rtol, atol, 'W3 ' + method)
        key3 = grid_key(w2, out)
        x3 = stacked(w2)
        src = tuple(x3.shape[-2:])
        if method == 'average':
            plan = warp._cached_plan(*key3, src, 'average', '<f4', dkey)
            check(plan is not None, 'W3 average plan')
            op = lambda: matmul_resample(x3, *plan[:6], float('nan'),  # noqa
                                         expected=plan[6], skipna=True)
            B, H, W = x3.shape
            Hd, Wd = plan[0].shape[0], plan[2].shape[0]
            ops = 2 * 2 * B * (H * W * Wd + Hd * H * Wd)
        else:
            plan = warp._cached_footprint_plan(*key3, src, dkey)
            op = lambda: footprint_resample(x3, *plan, 'med',  # noqa
                                            float('nan'))
            Hd, Wd = plan[0].shape[0], plan[3].shape[0]
            span = plan[0].shape[1] * plan[3].shape[1]
            ops = x3.shape[0] * Hd * Wd * span * int(np.ceil(np.log2(
                max(span, 2))))
        call_ms = cuda_ms(lambda: rs.apply(w2))
        op_ms = cuda_ms(op)
        bnd = bound(4 * x3.numel() + 4 * x3.shape[0] * Hd * Wd, ops)
        report('W3', 'Resample(res=2 x source, resampling=%s) of the W2 cube: '
               '%dx%d output, max abs diff %.3g vs CPU (rtol %g, atol %g)'
               % (method, Hd, Wd, diff, rtol, atol), call_ms, op_ms, bnd)
        del out, ref, x3

    # ---- W4: coregistration (bench.py's coregister cell) --------------------
    w4, w4_cpu = gen(W4_CUBE)
    coreg = ndt.Coregistration(reference=0, upsampling=10)
    m4 = w4['C11'].transpose('time', 'y', 'x').data
    s_card = phase_cross_correlation_batch(m4, m4[0], 10)
    s_cpu = phase_cross_correlation_batch(m4.cpu(), m4[0].cpu(), 10)
    check(torch.equal(s_card.cpu(), s_cpu), 'W4 shifts', s_card, s_cpu)
    out4 = coreg.apply(w4)
    ref4 = coreg.apply(w4_cpu)
    diff = hold_datasets(out4, ref4, 1e-5, 1e-6, 'W4 coregistration')
    # registration check (bench.py's): band-limited known sub-pixel shifts
    rng = np.random.RandomState(9)
    n = REG_SIZE
    spec = np.fft.fft2(rng.rand(n, n))
    cut = n * 40 // 512
    spec[cut:1 - cut, :] = 0
    spec[:, cut:1 - cut] = 0              # band-limited: alias-free shifts
    true = np.array([[1.3, -2.7], [-0.4, 0.8], [3.25, 1.75], [0.0, 0.0]])
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.fftfreq(n)[None, :]
    srcs = np.stack([np.real(np.fft.ifft2(
        spec * np.exp(-2j * np.pi * (fy * dy + fx * dx))))
        for dy, dx in true]).astype(np.float32)
    reg = np.real(np.fft.ifft2(spec)).astype(np.float32)
    est = phase_cross_correlation_batch(torch.from_numpy(srcs).to(dev),
                                        torch.from_numpy(reg).to(dev), 10)
    reg_err = float(np.abs(est.cpu().numpy() - true).max())
    check(reg_err <= 0.2, 'W4 registration error', reg_err)
    call_ms = cuda_ms(lambda: coreg.apply(w4))
    op_ms = cuda_ms(lambda: phase_cross_correlation_batch(m4, m4[0], 10))
    k4, ny4, nx4 = m4.shape
    bnd = fft_model(k4, ny4, nx4, len(W_NAMES))
    report('W4', 'Coregistration(reference=0, upsampling=10) of %d x %d x '
           '%d x 4 float32: shifts equal to the CPU\'s, cube max abs diff '
           '%.3g (rtol 1e-5, atol 1e-6); known shifts recovered within '
           '%.3f px (<= 0.2); "sampling alone" is the phase correlation'
           % (ny4, nx4, k4, diff, reg_err), call_ms, op_ms, bnd)
    del w4, w4_cpu, out4, ref4

    # ---- W5: W2's reprojected cube through the change chain, counted --------
    src5 = out2['bilinear']
    del out2, w2_cpu
    reset_counts()
    flt = src5.filter.nlmeans(r=2, f=1, sigma=2, h=3)
    change = flt.nd.change_omnibus(ml=3)
    torch.cuda.synchronize()
    counts_w5 = read_counts()
    check(all(counts_w5[n] > 0 for n in ('sepconv', 'nlmeans', 'omnibus',
                                         'omnibus_mixed')),
          'W5: a kernel of the chain was not launched', counts_w5)
    st = torch.stack([flt[v].transpose('y', 'x', 'time').data
                      for v in W_NAMES])                      # (4, y, x, t)
    looked = conv_cuda.sepconv2_plain(st, box_taps[0], box_taps[1])
    ref5 = change_detection_plain(looked.permute(1, 2, 3, 0).contiguous(),
                                  0.01, n=9)
    mism = int((change.transpose('y', 'x', 'time').data != ref5).sum())
    check(mism == 0, 'W5 change-map mismatches', mism)
    check(change.data.device.type == 'cuda', 'W5 on the card')
    chain_ms = cuda_ms(lambda: src5.filter.nlmeans(
        r=2, f=1, sigma=2, h=3).nd.change_omnibus(ml=3))
    phase('W5', 'reprojected cube %s -> .filter.nlmeans(r=2, f=1, sigma=2, '
          'h=3).nd.change_omnibus(ml=3): %d mismatches vs the plain f64 '
          'mixed scan of the same filtered cube; %d changes; chain %.3f ms '
          '(median of 7 after 2 warm-ups); launches %s | %s'
          % (tuple(change.shape), mism, int(change.data.sum()), chain_ms,
             json.dumps(counts_w5), card))
    return counts_w5


# ---- T1-T3: the training path -----------------------------------------------

T_STEPS = 5                 # train_step calls of T1
T_RING = 8                  # masked outer ring of T1's labels (pixels)
T2_EPOCHS = 150             # examples/forest_classification.py's settings
T2_CHECK_EPOCHS = 10
FEATURE_NAMES = ('c11_mean', 'c11_std', 'c22_mean', 'c22_std', 'ratio',
                 'coherence', 'p_change')


def features_bound(looked):
    """(ms, what sets it) of ``change_features`` on a (y, x, t, 4) cube:
    the cube read once and the (y, x, 7) features written once; about 50
    operations per pixel and date (determinant, log, ratio, coherence,
    sums) and 230 per pixel (two incomplete gamma functions and the
    statistic), counted from the formula."""
    ny, nx, k, _ = looked.shape
    nbytes = looked.numel() * looked.element_size() + ny * nx * 7 * 4
    return bound(nbytes, ny * nx * (50 * k + 230))


def classifier_bound(n, n_features, hidden, n_classes, epochs):
    """(ms, what sets it) of ``TorchClassifier.fit``: X (n, features)
    float32 read twice an epoch (the forward and the weight gradient),
    and each epoch's f32 operations (2 per multiply-add of the two
    products forward, twice that backward, plus the bias, ReLU,
    log-softmax and loss terms)."""
    sizes = (n_features,) + tuple(hidden) + (n_classes,)
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    per_sample = 6 * macs + 4 * sum(sizes[1:]) + 12 * n_classes
    return bound(2 * n * n_features * 4 * epochs, n * per_sample * epochs)


def profiled(fn):
    """(wall ms, device-busy ms, device events, top kernels) of one call
    under torch.profiler, after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float('-inf')          # union of the device spans, us
    per_name = defaultdict(float)
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        per_name[name[:40]] += (e - s) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
    return wall, busy / 1e3, len(spans), top


def say_profile(tag, label, fn, card):
    """One call under torch.profiler: wall, device-busy share, device
    events and the kernels that took the most device time."""
    wall, busy, events, top = profiled(fn)
    phase(tag, '%s under torch.profiler: wall %.3f ms, device busy %.3f ms '
          '(%.1f%%), %d device events; top %s | %s'
          % (label, wall, busy, 100.0 * busy / wall, events,
             ', '.join('%s %.3f ms' % kv for kv in top), card))


def run_training_phases(ndt, dev, card, cuda_ms, reset_counts, read_counts,
                        cube, labels):
    """T1-T3: the flagship model trained on the bench cube, a classifier
    fitted on its features, checkpoints of both; every result held
    against the same port calls on the CPU. Returns T1's launches."""
    import tempfile

    import torch
    from nd_tpu_torch.classify import TorchClassifier
    from nd_tpu_torch.core import DataArray, Dataset
    from nd_tpu_torch.models.checkpoint import (Checkpointer, load_params,
                                                save_params)

    cpu = torch.device('cpu')
    model = ndt.SARChangePipeline(ml=3, n=1, alpha=0.9, n_classes=2,
                                  lr=0.05)
    cube_cpu, labels_cpu = cube.cpu(), labels.cpu()

    # ---- T1: five train_steps at full width, counted ------------------------
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    params = model.init_params(seed=0)
    params_cpu = model.init_params(seed=0, device=cpu)
    losses, per_step = [], []
    reset_counts()
    for _ in range(T_STEPS):
        before = read_counts()
        params, loss = model.train_step(params, cube, labels)
        losses.append(loss)
        per_step.append({k: v - before[k] for k, v in read_counts().items()
                         if v != before[k]})
    torch.cuda.synchronize()
    counts_t1 = read_counts()
    check(all(s == {'sepconv': 1} for s in per_step),
          'T1: one sepconv launch a step and no other kernel', per_step)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), 'T1 losses finite', losses)
    losses_cpu = []
    for _ in range(T_STEPS):
        params_cpu, loss = model.train_step(params_cpu, cube_cpu, labels_cpu)
        losses_cpu.append(loss)
    losses_cpu = torch.stack(losses_cpu)
    ok, loss_diff = allclose(losses, losses_cpu, 1e-5, 0.0)
    check(ok, 'T1 losses against the CPU', losses, losses_cpu)
    param_diff = 0.0
    for k in ('w', 'b'):
        ok, top = allclose(params[k], params_cpu[k], 1e-4, 1e-6)
        check(ok and params[k].device.type == 'cuda', 'T1 params', k, top)
        param_diff = max(param_diff, top)
    looked = ndt.multilook(cube, model.ml)
    feats = model.features(looked)
    feats_cpu = model.features(ndt.multilook(cube_cpu, model.ml))
    ok, feat_diff = allclose(feats, feats_cpu, 1e-5, 1e-5)
    check(ok and feats.shape == (cube.shape[0], cube.shape[1], 7),
          'T1 first-step features against the CPU', feat_diff)
    p0 = model.init_params(seed=0)
    step_ms = cuda_ms(lambda: model.train_step(p0, cube, labels))
    ml_ms = cuda_ms(lambda: ndt.multilook(cube, model.ml))
    feat_ms = cuda_ms(lambda: model.features(looked))
    head_ms = cuda_ms(lambda: model.head_step(p0, feats, labels))
    fb = features_bound(looked)
    phase('T1', 'SARChangePipeline(ml=3, n=1, alpha=0.9, n_classes=2, '
          'lr=0.05) on %s float32, %d train_steps from init_params(seed=0), '
          'labels: phase 4\'s change map any over time, %d-pixel ring '
          'masked (%d labelled pixels, %d of class 1): losses %s; against '
          'the CPU: losses max abs diff %.3g (rtol 1e-5), params %.3g '
          '(rtol 1e-4, atol 1e-6), first-step features %.3g (rtol 1e-5, '
          'atol 1e-5); launches %s; peak device memory %.2f GiB, %.2f GiB '
          'above the %.2f GiB the script held before T1'
          % (tuple(cube.shape), T_STEPS, T_RING, int((labels >= 0).sum()),
             int((labels == 1).sum()),
             ', '.join('%.6f' % v for v in losses.tolist()), loss_diff,
             param_diff, feat_diff, json.dumps(counts_t1), peak,
             peak - held, held))
    phase('T1', 'train_step %.3f ms = multilook %.3f ms + change_features '
          '%.3f ms + head (loss, gradient, SGD update) %.3f ms (each the '
          'median of 7 after 2 warm-ups); change_features bound %.3f ms '
          '(%s), %.1f%% of it | %s'
          % (step_ms, ml_ms, feat_ms, head_ms, fb[0], fb[1],
             100.0 * fb[0] / feat_ms, card))
    say_profile('T1', 'one train_step', lambda: model.train_step(p0, cube,
                                                                 labels),
                card)
    del looked, feats_cpu, cube_cpu

    # ---- T2: TorchClassifier on T1's features --------------------------------
    ny, nx = labels.shape
    coords = {'y': np.arange(ny, dtype=np.float64),
              'x': np.arange(nx, dtype=np.float64)}
    fds = Dataset({name: (('y', 'x'), feats[..., i].contiguous())
                   for i, name in enumerate(FEATURE_NAMES)}, coords=coords,
                  device=dev)
    classes = DataArray(labels + 1, dims=('y', 'x'), coords=coords,
                        device=dev)                 # the ring becomes 0
    fds_cpu = on_device(fds, cpu)
    classes_cpu = DataArray(classes.data.cpu(), dims=('y', 'x'),
                            coords=coords, device=cpu)
    reset_counts()
    short = TorchClassifier(hidden=(16,), epochs=T2_CHECK_EPOCHS, lr=0.05)
    short.fit(fds, classes)
    short_cpu = TorchClassifier(hidden=(16,), epochs=T2_CHECK_EPOCHS,
                                lr=0.05).fit(fds_cpu, classes_cpu)
    # Each parameter tensor within 1e-4 of its largest magnitude (plus
    # 1e-6): Adam normalises each gradient, so float32 sums over 1M
    # samples taken in another order move single weights near 0 by more
    # than an elementwise 1e-4 (on the CPU, the same fit with the grid
    # transposed moved a weight of -0.055 by 1.7e-5).
    short_diff, short_rel = 0.0, 0.0
    for pair, pair_cpu in zip(short.params, short_cpu.params):
        for a, b in zip(pair, pair_cpu):
            top = float((a.cpu() - b).abs().max())
            scale = float(b.abs().max())
            check(top <= 1e-4 * scale + 1e-6 and a.device.type == 'cuda',
                  'T2 params at %d epochs' % T2_CHECK_EPOCHS, top, scale)
            short_diff = max(short_diff, top)
            short_rel = max(short_rel, top / scale)
    clf = TorchClassifier(hidden=(16,), epochs=T2_EPOCHS, lr=0.05)
    clf.fit(fds, classes)
    pred = clf.predict(fds)
    torch.cuda.synchronize()
    counts_t2 = read_counts()
    check(not any(counts_t2.values()), 'T2 launched a kernel', counts_t2)
    check(pred.data.device.type == 'cuda' and pred.dims == ('y', 'x'),
          'T2 predictions', pred.data.device, pred.dims)
    pred_cpu = TorchClassifier(hidden=(16,), epochs=T2_EPOCHS,
                               lr=0.05).fit(fds_cpu,
                                            classes_cpu).predict(fds_cpu)
    agree = float((pred.data.cpu() == pred_cpu.data).double().mean())
    check(agree >= 0.999, 'T2 predictions against the CPU', agree)
    lab = classes.data > 0
    n_samples = int(lab.sum())
    accuracy = float((pred.data[lab] == classes.data[lab]).double().mean())
    fit_ms = cuda_ms(lambda: TorchClassifier(hidden=(16,), epochs=T2_EPOCHS,
                                             lr=0.05).fit(fds, classes),
                     reps=3, warmup=1)
    predict_ms = cuda_ms(lambda: clf.predict(fds))
    cb = classifier_bound(n_samples, 7, (16,), 2, T2_EPOCHS)
    phase('T2', 'TorchClassifier(hidden=(16,), epochs=%d, lr=0.05) on a '
          'Dataset of T1\'s 7 features (%d x %d, %d labelled samples, '
          'labels + 1): at %d epochs params max abs diff %.3g to the CPU, '
          '%.3g of the tensor\'s largest magnitude (<= 1e-4, plus 1e-6); at '
          '%d epochs predictions equal to the CPU\'s on %.5f%% of pixels '
          '(>= 99.9%%); accuracy %.4f (%.4f predicting the majority class); '
          'no kernel launched'
          % (T2_EPOCHS, ny, nx, n_samples, T2_CHECK_EPOCHS, short_diff,
             short_rel, T2_EPOCHS, 100.0 * agree, accuracy,
             1.0 - float((classes.data == 2).sum()) / n_samples))
    phase('T2', 'fit %.3f ms (median of 3 after 1 warm-up; %.4f ms an '
          'epoch), predict %.3f ms (median of 7 after 2) | fit bound %.3f ms '
          '(%s), %.1f%% of it | %s'
          % (fit_ms, fit_ms / T2_EPOCHS, predict_ms, cb[0], cb[1],
             100.0 * cb[0] / fit_ms, card))

    say_profile('T2', 'a %d-epoch fit' % T2_CHECK_EPOCHS,
                lambda: TorchClassifier(hidden=(16,), epochs=T2_CHECK_EPOCHS,
                                        lr=0.05).fit(fds, classes), card)

    # ---- T3: checkpoints ----------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'params.npz')
        save_params(params, path)
        back = load_params(path, like=model.init_params(seed=1))
        check(all(back[k].device.type == 'cuda'
                  and torch.equal(back[k], params[k]) for k in params),
              'T3 pipeline params round trip')
        save_params(clf.params, path)
        back = load_params(path, like=clf.params)
        check(all(a.device.type == 'cuda' and torch.equal(a, b)
                  for pair, pair_back in zip(clf.params, back)
                  for a, b in zip(pair, pair_back)),
              'T3 classifier params round trip')
        ck = Checkpointer(os.path.join(tmp, 'ck'), max_to_keep=2)
        for step in range(3):
            ck.save(step, {'head': {k: v + step for k, v in params.items()},
                           'classifier': clf.params})
        latest = ck.latest_step()
        kept = sorted(os.listdir(os.path.join(tmp, 'ck')))
        state = ck.restore(like={'head': params, 'classifier': clf.params})
        ck.close()
        check(latest == 2 and kept == ['step_1.npz', 'step_2.npz'],
              'T3 Checkpointer retention', latest, kept)
        check(all(torch.equal(state['head'][k], params[k] + 2)
                  for k in params)
              and all(torch.equal(a, b) for pair, pair_back
                      in zip(clf.params, state['classifier'])
                      for a, b in zip(pair, pair_back)),
              'T3 Checkpointer restore')
    phase('T3', 'save_params/load_params of T1\'s params and T2\'s (w, b) '
          'list: bit for bit onto the card; Checkpointer(max_to_keep=2) '
          'over 3 saves: latest_step() = %d, kept %s, restore equal'
          % (latest, ', '.join(kept)))
    return counts_t1


# ---- S1-S5: the dated stack ---------------------------------------------------

S_NAN = 0.02                # no-data share of the dated stack (seeded)
S_SLAB = 64                 # rows held against the CPU in S3 and S4
S_MODES = (('reflect', 0.0), ('nearest', 0.0), ('mirror', 0.0),
           ('wrap', 0.0), ('constant', 0.0), ('constant', 1.5))
def disk(r):
    """The (2r+1, 2r+1) disk of radius**2 <= r*r + 1, normalised, zero
    taps included."""
    ax = np.arange(-r, r + 1)
    d = (ax[:, None] ** 2 + ax[None, :] ** 2 <= r * r + 1).astype(float)
    return d / d.sum()


DISK = disk(2)                                       # 21 taps, rank > 1
LAPLACE27 = -np.ones((3, 3, 3))                      # the 27-point Laplacian
LAPLACE27[1, 1, 1] = 26.0


def stencil_bound(x, taps):
    """Each element read once and written once; per output one product
    per tap and an add per tap after the first (zero taps included)."""
    return bound(2 * x.numel() * x.element_size(),
                 x.numel() * (2 * taps - 1))


def run_series_phases(ndt, dev, card, cuda_ms, reset_counts, read_counts,
                      cube, stack, box_taps, row_ms, err):
    """S1-S5: the stencil kernel against its plain version (every mode)
    with its time, bound and cuDNN yardstick; ``njobs=4`` against
    ``njobs=1`` on the card, counted; the time-series chain on a dated
    one-year stack with 2% no-data (gap filling, monthly composites, the
    disk filter, the change test), with pandas blocked; the grouped
    reductions at full width; ``ds.nd.apply`` on the composites. Returns
    the launches of S2's and S3's runs."""
    import torch
    import torch.nn.functional as F
    from nd_tpu_torch import utils
    from nd_tpu_torch.core import DataArray, Dataset
    from nd_tpu_torch.ops import conv_cuda, nlmeans_cuda, stencil_cuda
    from nd_tpu_torch.ops.change import change_detection_plain
    from nd_tpu_torch.ops.conv import convolve, pad_reflect
    from nd_tpu_torch.scan_sweep import back_to_back_ms, profiler_ms

    names = ('C11', 'C12__re', 'C12__im', 'C22')
    cpu = torch.device('cpu')

    def timed(label, key, kern, plain, bnd, lib):
        """plain, kernel, kernel, plain (median of 7 after 2 warm-ups
        each); the yardstick after them; then the kernel's device time a
        launch over 50 back-to-back calls and under torch.profiler."""
        p1 = cuda_ms(plain)
        k1 = cuda_ms(kern)
        k2 = cuda_ms(kern)
        p2 = cuda_ms(plain)
        k_ms, p_ms = min(k1, k2), min(p1, p2)
        lib_ms = cuda_ms(lib) if lib is not None else None
        b2b, prof = back_to_back_ms(kern), profiler_ms(kern, 'stencil')
        phase('S1', '%-34s kernel %.3f ms | plain %.3f ms | x%.2f | bound '
              '%.3f ms (%s), %.1f%% of it | cuDNN (TF32 off) %s | %s'
              % (label, k_ms, p_ms, p_ms / k_ms, bnd[0], bnd[1],
                 100.0 * bnd[0] / k_ms,
                 'not timed' if lib_ms is None else '%.3f ms' % lib_ms,
                 card))
        phase('S1', '%-34s device time a launch: back-to-back %.4f ms '
              '(%.1f%% of the bound), torch.profiler %.4f ms; single call '
              '%.4f ms, so the wrapper\'s host share %.4f ms | %s'
              % (label, b2b, 100.0 * bnd[0] / b2b, prof, k_ms, k_ms - prof,
                 card))
        if key:
            row_ms[key] = {'ms': k_ms, 'plain_ms': p_ms, 'bound_ms': bnd[0],
                           'bound_by': bnd[1], 'library_ms': lib_ms}

    # ---- S1: the stencil kernel against its plain version ------------------
    t_s = time.perf_counter()
    rng = np.random.RandomState(SEED + 11)
    bench = cube.reshape(1, NY, NX, 1, K * 4)               # (y, x) of 4 vars
    c11 = stack[..., 0].contiguous()                        # (y, x, t)
    long5 = c11.reshape(1, NY, NX, KL, 1)
    f64 = torch.from_numpy(make_cube(256, 256, K, seed=SEED + 12)).to(
        dev).double()
    f64 = f64.reshape(1, f64.shape[0], f64.shape[1], 1, -1)
    ragged = torch.from_numpy(rng.rand(1, 37, 53, 7, 1).astype(
        np.float32)).to(dev)
    disk3 = np.flip(DISK)[:, :, None]                       # flipped, k2 = 1

    def stacked(c, k):
        """The view ConvolutionFilter launches for a Dataset of the four
        variables over (y, x): (variable, y, x, 1, time)."""
        return c[:, :, :k].permute(3, 0, 1, 2).contiguous().reshape(
            4, NY, NX, 1, k)

    comp11 = stacked(stack, 11)              # S3's launch: 11 composites
    cases = [('disk (y,x) stacked 4x1024x1024x11 (S3)', comp11, disk3),
             ('disk (y,x) stacked 4x1024x1024x12 (S2)', stacked(cube, K),
              disk3),
             ('disk (y,x) stacked 4x1024x1024x3 (S2 chunk)',
              stacked(cube, K // 4), disk3),
             ('disk (y,x) bench 1024x1024x12x4', bench, disk3),
             ('Laplace27 (y,x,t) C11 1024x1024x56', long5,
              np.flip(LAPLACE27)),
             ('disk float64 256x256x12x4', f64, disk3),
             ('random 3x4x2 ragged 37x53x7', ragged, rng.rand(3, 4, 2)),
             ('181x181 direct route 4x96x96x4', torch.from_numpy(
                 rng.rand(4, 96, 96, 1, 4).astype(np.float32)).to(dev),
              rng.rand(181, 181, 1))]

    def small(shape, dtype=torch.float32):
        return torch.from_numpy(rng.rand(*shape)).to(dtype).to(dev)
    k432 = rng.rand(4, 3, 2) - 0.3
    k511 = rng.rand(5, 1, 1) - 0.3
    k99 = rng.rand(9, 9, 1) - 0.3
    k333 = rng.rand(3, 3, 3) - 0.3
    for dtype, tag in ((torch.float32, ''), (torch.float64, ' float64')):
        cases += [('edge n0 19 (not a run multiple)' + tag,
                   small((1, 19, 40, 1, 12), dtype), disk3),
                  ('edge n0 3 < k0' + tag, small((1, 3, 40, 1, 12), dtype),
                   disk3),
                  ('edge n1 1' + tag, small((1, 40, 1, 1, 12), dtype), disk3),
                  ('edge row 1' + tag, small((1, 40, 50, 1, 1), dtype),
                   disk3),
                  ('edge outer 4 row 11' + tag,
                   small((4, 30, 40, 1, 11), dtype), disk3),
                  ('edge row 48' + tag, small((1, 30, 40, 1, 48), dtype),
                   disk3),
                  ('edge disk 3x3' + tag, small((4, 30, 40, 1, 11), dtype),
                   np.flip(disk(1))[:, :, None]),
                  ('edge disk 7x7' + tag, small((4, 30, 40, 1, 11), dtype),
                   np.flip(disk(3))[:, :, None]),
                  ('edge 4x3x2' + tag,
                   small((4, 30, 40, 11, 1), dtype), k432),
                  ('edge (5,1,1)' + tag, small((1, 40, 30, 1, 12), dtype),
                   k511),
                  ('edge (1,5,1)' + tag, small((1, 40, 30, 1, 12), dtype),
                   k99[:1, :5]),
                  ('edge 9x9 weights in shared memory' + tag,
                   small((1, 24, 20, 1, 6), dtype), k99),
                  ('edge Laplacian view' + tag,
                   small((1, 30, 28, 20, 1), dtype), k333)]
    # the unrolled builds' limits: 7 rows x 9 row taps (63 weights by
    # value); 4 x 9 in float64 (36, past the 32 by value) the generic build
    cases += [('edge 7x9 unrolled', small((1, 30, 28, 1, 5)),
               rng.rand(7, 9, 1) - 0.3),
              ('edge 4x9 float64 generic',
               small((1, 30, 28, 1, 5), torch.float64),
               rng.rand(4, 9, 1) - 0.3)]
    worst = 0.0
    for label, x, k in cases:
        tiled = stencil_cuda.stencil_tiled(*x.shape[1:], *k.shape,
                                           x.element_size())
        check(tiled == (k.shape[0] < 100), 'stencil route', label, tiled)
        for mode, cval in S_MODES:
            got = stencil_cuda.stencil(x, k, mode, cval)
            ref = stencil_cuda.stencil_plain(x, k, mode, cval)
            torch.cuda.synchronize()
            diff = float((got - ref).abs().max())
            check(diff == 0 and bool(torch.isfinite(got).all()),
                  'stencil', label, mode, cval, diff)
            worst = max(worst, diff)
        phase('S1', 'stencil %s (%s, %s): max abs diff 0 in modes %s'
              % (label, 'tiled' if tiled else 'direct', x.dtype,
                 ', '.join('%s(%g)' % m for m in S_MODES)))
        del got, ref
    # a NaN under the disk's zero taps propagates (0 * NaN), and a chunk
    # whose seam cuts the whole call's tiles equals the whole call's rows
    xn = small((4, 30, 40, 1, 11))
    xn[1, 7, 9, 0, 3] = float('nan')
    xn[2, 0, 0, 0, 0] = float('nan')
    xs = small((4, 50, 40, 1, 11))
    for mode, cval in S_MODES:
        got = stencil_cuda.stencil(xn, disk3, mode, cval)
        ref = stencil_cuda.stencil_plain(xn, disk3, mode, cval)
        nan = ref.isnan()
        check(int(nan.sum()) > 21 and torch.equal(got.isnan(), nan)
              and torch.equal(got[~nan], ref[~nan]), 'stencil NaN', mode,
              cval)
        whole = stencil_cuda.stencil(xs, disk3, mode, cval)
        part = stencil_cuda.stencil(xs[:, 11:31].contiguous(), disk3, mode,
                                    cval)
        check(torch.equal(part[:, 2:18], whole[:, 13:29]), 'stencil seam',
              mode, cval)
    del xn, xs, got, ref, whole, part
    phase('S1', 'a NaN under the disk\'s zero taps: NaN where the plain '
          'version has it, equal elsewhere; a chunk (rows 11..30 of 50) '
          'whose seam cuts the tiles equals the whole call: every mode')
    # a kernel over four axes: sums of three-axis stencils, on the card
    # against the same sums on the CPU
    x4 = torch.from_numpy(rng.rand(64, 64, K, 4).astype(np.float32))
    k4 = rng.rand(3, 2, 3, 2)
    diff = float((convolve(x4.to(dev), k4, mode='wrap').cpu()
                  - convolve(x4, k4, mode='wrap')).abs().max())
    check(diff == 0, 'four-axis stencil', diff)
    worst = max(worst, diff)
    err['stencil'] = worst
    phase('S1', 'four-axis kernel (3,2,3,2) on 64x64x12x4: max abs diff 0 '
          'to the CPU')

    def cudnn_2d(x5, k):
        """cuDNN's depthwise conv2d of the already padded (outer, n0, n1,
        1, inner) view as NHWC: the VALID part only."""
        pads = [(0, 0)] + [((n - 1) // 2, n // 2) for n in k.shape[:2]] \
            + [(0, 0)]
        xin = pad_reflect(x5[:, :, :, 0], pads).permute(0, 3, 1, 2)
        c = xin.shape[1]
        w = torch.tensor(np.ascontiguousarray(k[:, :, 0]), dtype=x5.dtype,
                         device=dev).expand(c, 1, *k.shape[:2]).contiguous()
        return (lambda: F.conv2d(xin, w, groups=c),
                lambda out: out.permute(0, 2, 3, 1)[:, :, :, None])

    def cudnn_3d(x5, k):
        pads = [((n - 1) // 2, n // 2) for n in k.shape]
        xin = pad_reflect(x5[0, ..., 0], pads)[None, None]
        w = torch.tensor(np.ascontiguousarray(k), dtype=x5.dtype,
                         device=dev)[None, None]
        return (lambda: F.conv3d(xin, w), lambda out: out[0, 0][None, ...,
                                                                  None])

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for label, key, x, k, yard in (
                ('stencil disk stacked composites', 'stencil', comp11,
                 disk3, cudnn_2d),
                ('stencil disk bench cube (y,x,48)', None, bench, disk3,
                 cudnn_2d),
                ('stencil Laplace27 long-stack C11', None, long5,
                 np.flip(LAPLACE27), cudnn_3d)):
            call, layout = yard(x, k)
            got = stencil_cuda.stencil(x, k)
            diff = float((layout(call()) - got).abs().max())
            check(diff <= 1e-5 * float(x.abs().max())
                  * float(np.abs(k).sum()), 'cuDNN yardstick', label, diff)
            timed(label, key, lambda: stencil_cuda.stencil(x, k),
                  lambda: stencil_cuda.stencil_plain(x, k),
                  stencil_bound(x, int(np.prod(k.shape))), call)
            del got
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del f64, ragged, cases, comp11
    phase('S1', 'ran %.1f s' % (time.perf_counter() - t_s))

    # ---- S2: njobs on the card, counted ---------------------------------
    t_s = time.perf_counter()
    ds_bench = Dataset({v: (('y', 'x', 'time'), cube[..., i])
                        for i, v in enumerate(names)})
    ds_c11 = Dataset({'C11': (('y', 'x', 'time'), c11)})
    counts_s2 = []
    for label, algo, ds in (
            ('ConvolutionFilter disk (y,x) bench cube',
             ndt.ConvolutionFilter(dims=('y', 'x'), kernel=DISK), ds_bench),
            ('ConvolutionFilter Laplace27 (y,x,t) C11',
             ndt.ConvolutionFilter(dims=('y', 'x', 'time'),
                                   kernel=LAPLACE27), ds_c11),
            ('NLMeansFilter r=2 f=1 bench cube',
             ndt.NLMeansFilter(dims=('y', 'x'), r=2, f=1, sigma=2, h=3),
             ds_bench)):
        dim = algo._parallel_dimension(ds)
        halo = algo._buffer(dim)
        one = algo.apply(ds)
        chunk = next(iter(utils.xr_split(ds, dim, 4, halo)))
        reset_counts()
        algo.apply(chunk)
        torch.cuda.synchronize()
        per_chunk = read_counts()
        reset_counts()
        four = algo.apply(ds, njobs=4)
        torch.cuda.synchronize()
        got_counts = read_counts()
        counts_s2.append(got_counts)
        check(all(got_counts[n] == 4 * per_chunk[n] for n in got_counts)
              and sum(per_chunk.values()) > 0, 'njobs launches', label,
              per_chunk, got_counts)
        for v in one.data_vars:
            check(torch.equal(one[v].data, four[v].data)
                  and one[v].dims == four[v].dims, 'njobs=4', label, v)
        phase('S2', '%s: njobs=4 (split along %s, halo %d) equals njobs=1 '
              'bit for bit; launches %s (4 x a chunk\'s %s) | %s'
              % (label, dim, halo,
                 json.dumps({n: c for n, c in got_counts.items() if c}),
                 json.dumps({n: c for n, c in per_chunk.items() if c}),
                 card))
        del one, four
    del ds_bench, ds_c11
    phase('S2', 'ran %.1f s' % (time.perf_counter() - t_s))

    # ---- S3: the time-series chain at full width, counted -----------------
    t_s = time.perf_counter()
    times = np.datetime64('2023-01-03', 'ns') \
        + np.arange(KL) * np.timedelta64(6, 'D')
    gaps = torch.from_numpy(np.random.RandomState(SEED + 13).rand(
        NY, NX, KL) < S_NAN).to(dev)
    dated = stack.clone()
    dated[gaps] = float('nan')
    del gaps
    ds_dated = Dataset({v: (('y', 'x', 'time'), dated[..., i])
                        for i, v in enumerate(names)},
                       coords={'time': times})
    disk_f = ndt.ConvolutionFilter(dims=('y', 'x'), kernel=DISK)
    omn = ndt.OmnibusTest(ml=3, alpha=0.99)
    saved = sys.modules.get('pandas', False)
    sys.modules['pandas'] = None            # the chain must not need it
    try:
        reset_counts()
        t0 = time.perf_counter()
        filled = ds_dated.interpolate_na(dim='time')
        comp = filled.resample(time='1MS').mean()
        flt = disk_f.apply(comp)
        change = omn.apply(flt)
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t0
        counts_s3 = read_counts()
    finally:
        if saved is False:
            del sys.modules['pandas']
        else:
            sys.modules['pandas'] = saved
    check(counts_s3['stencil'] > 0 and counts_s3['sepconv'] > 0
          and counts_s3['omnibus'] > 0, 'S3 kernels', counts_s3)
    ks = comp.sizes['time']
    check(ks == 11 and comp['time'].values[0] == np.datetime64('2023-01-01')
          and change.dims == ('y', 'x', 'time')
          and tuple(change.data.shape) == (NY, NX, ks)
          and change.data.device.type == 'cuda', 'S3 shapes', ks,
          change.dims)
    comp_all = torch.stack([comp[v].data for v in names], -1)
    check(bool(torch.isfinite(comp_all).all()), 'S3 composites finite')
    # the chain's stencil launch against its plain version on the same
    # stacked composites
    st = torch.stack([flt[v].data for v in names])          # (4, y, x, t)
    check(all(flt[v].dims == comp[v].dims == ('y', 'x', 'time')
              for v in names), 'S3 filter dims')
    flt_ref = stencil_cuda.stencil_plain(
        torch.stack([comp[v].data for v in names]).reshape(4, NY, NX, 1, ks),
        disk3, 'reflect', 0.0)
    flt_diff = float((st.reshape(flt_ref.shape) - flt_ref).abs().max())
    check(flt_diff == 0, 'S3 filter vs stencil_plain', flt_diff)
    err['stencil'] = max(err['stencil'], flt_diff)
    del flt_ref
    looked = conv_cuda.sepconv2_plain(st, box_taps[0], box_taps[1])
    ref_change = change_detection_plain(
        looked.permute(1, 2, 3, 0).contiguous(), 0.99, n=9)
    mism = int((change.data != ref_change).sum())
    check(mism == 0, 'S3 change-map mismatches', mism)
    del st, looked, ref_change
    # the composites held against the CPU on a slab
    slab = Dataset({v: (('y', 'x', 'time'), dated[:S_SLAB, ..., i].cpu())
                    for i, v in enumerate(names)}, coords={'time': times})
    comp_cpu = slab.interpolate_na(dim='time').resample(time='1MS').mean()
    worst = 0.0
    for v in names:
        ok, top = allclose(comp[v].data[:S_SLAB], comp_cpu[v].data, 1e-6,
                           1e-6)
        check(ok, 'S3 composites vs CPU', v, top)
        worst = max(worst, top)
    phase('S3', 'dated stack %s (%d dates from %s at a 6-day revisit, %.0f%% '
          'no-data): interpolate_na -> resample(1MS).mean -> disk filter -> '
          'OmnibusTest(ml=3, alpha=0.99), pandas blocked: %.3f s; %d '
          'monthly composites; %d change-map mismatches vs the plain float64 '
          "'mixed' scan; %d changes; filter vs stencil_plain on the stacked "
          'composites: max abs diff %g; composites vs CPU on %d rows: max '
          'abs diff %.3g (rtol 1e-6, atol 1e-6); launches %s | %s'
          % (tuple(dated.shape), KL, times[0], 100 * S_NAN, chain_s, ks,
             mism, int(change.data.sum()), flt_diff, S_SLAB, worst,
             json.dumps({n: c for n, c in counts_s3.items() if c}), card))
    steps = [('interpolate_na', lambda: ds_dated.interpolate_na(dim='time')),
             ('resample(1MS).mean', lambda: filled.resample(
                 time='1MS').mean()),
             ('ConvolutionFilter disk', lambda: disk_f.apply(comp)),
             ('OmnibusTest', lambda: omn.apply(flt))]
    phase('S3', 'steps (CUDA events, median of 3 after 1 warm-up): %s | %s'
          % (', '.join('%s %.3f ms' % (n, cuda_ms(fn, 3, 1))
                       for n, fn in steps), card))
    del filled, flt, change, comp_all, slab, comp_cpu
    phase('S3', 'ran %.1f s' % (time.perf_counter() - t_s))

    # ---- S4: grouped reductions at full width --------------------------------
    t_s = time.perf_counter()
    c11_dated = ds_dated['C11']
    check(c11_dated.size > 2 ** 24, 'S4 input size', c11_dated.size)
    w = DataArray(np.linspace(1.0, 2.0, KL).astype(np.float32),
                  dims=('time',), device=dev)
    c11_slab = DataArray(c11_dated.data[:S_SLAB].cpu(),
                         dims=('y', 'x', 'time'), coords={'time': times},
                         name='C11')
    w_cpu = DataArray(w.data.cpu(), dims=('time',))
    calls = [('quantile(0.9, time)', lambda d, w: d.quantile(0.9,
                                                              dim='time')),
             ('median(time)', lambda d, w: d.median('time')),
             ('rolling(time=3, center).median',
              lambda d, w: d.rolling(time=3, center=True).median()),
             ('coarsen(time=4).mean', lambda d, w: d.coarsen(time=4).mean()),
             ('groupby(time.month).mean',
              lambda d, w: d.groupby('time.month').mean()),
             ('weighted(w).mean(time)',
              lambda d, w: d.weighted(w).mean('time'))]
    for label, fn in calls:
        got = fn(c11_dated, w)
        ref = fn(c11_slab, w_cpu)
        check(got.dims == ref.dims and got.data.device.type == 'cuda',
              'S4 dims', label, got.dims, ref.dims)
        ok, top = allclose(got.isel(y=slice(0, S_SLAB)).data, ref.data,
                           1e-6, 1e-6)
        check(ok, 'S4 vs CPU', label, top)
        ms = cuda_ms(lambda: fn(c11_dated, w), 3, 1)
        phase('S4', '%-32s %s -> %s: %.3f ms (median of 3 after 1); vs CPU '
              'on %d rows max abs diff %.3g (rtol 1e-6, atol 1e-6) | %s'
              % (label, tuple(c11_dated.shape), tuple(got.shape), ms,
                 S_SLAB, top, card))
        del got, ref
    phase('S4', 'quantile and median ran on the %d-element variable (past '
          "torch.quantile's 2**24 limit); ran %.1f s"
          % (c11_dated.size, time.perf_counter() - t_s))
    del c11_dated, c11_slab, ds_dated, dated

    # ---- S5: ds.nd.apply on the composites ------------------------------------
    def span_ratio(x):
        s = x[:, 0] + x[:, 3]
        return s / s.mean(0)

    before = dict(utils.routes)
    got = comp.nd.apply(span_ratio, signature='(time,var)->(time)')
    torch.cuda.synchronize()
    check(utils.routes['vmap'] == before['vmap'] + 1
          and utils.routes['host'] == before['host'], 'S5 route',
          before, utils.routes)
    stacked = comp.to_array('var').stack(z=('y', 'x')).transpose(
        'z', 'time', 'var').data
    s = stacked[:, :, 0] + stacked[:, :, 3]
    direct = (s / s.mean(1, keepdim=True)).reshape(NY, NX, -1)
    got = got.transpose('y', 'x', 'time')
    diff = float((got.data - direct).abs().max())
    check(diff == 0 and got.data.device.type == 'cuda', 'S5 apply', diff)
    ms = cuda_ms(lambda: comp.nd.apply(span_ratio,
                                       signature='(time,var)->(time)'), 3, 1)
    phase('S5', "ds.nd.apply(span ratio, '(time,var)->(time)') on %s "
          'composites: the vmap route ran (routes %s), equal bit for bit to '
          'the direct expression; %.3f ms | %s'
          % (tuple(comp['C11'].shape) + (len(names),),
             json.dumps(utils.routes), ms, card))
    return tuple(counts_s2) + (counts_s3,)


# ---- I1-I4: the I/O layer -----------------------------------------------------

I_CUT = 512                 # I3 and I4: a 512 x 512 x 12 cut of the cube
I_SHIFT = 0.37              # I4: the copy's offset, in pixels of the grid
I_RES = 10.0                # I1-I4: metres a pixel (EPSG:32633)


def io_dataset(cube, ny, nx, x0=5e5, y0=4e6, device=None):
    """The cube as the quick start's file holds it: C11, C12 (complex),
    C22 over (y, x, time) with a 12-day time coordinate from 2023-01-03,
    UTM coordinates at ``I_RES`` and ``crs``/``transform`` attrs."""
    import torch
    from nd_tpu_torch.core import Dataset
    k = cube.shape[2]
    times = np.datetime64('2023-01-03', 'ns') \
        + np.arange(k) * np.timedelta64(12, 'D')
    part = cube[:ny, :nx]
    return Dataset(
        {'C11': (('y', 'x', 'time'), part[..., 0]),
         'C12': (('y', 'x', 'time'), torch.complex(part[..., 1],
                                                    part[..., 2])),
         'C22': (('y', 'x', 'time'), part[..., 3])},
        coords={'y': y0 - I_RES * (np.arange(ny) + 0.5),
                'x': x0 + I_RES * (np.arange(nx) + 0.5), 'time': times},
        attrs={'crs': 'epsg:32633',
               'transform': (I_RES, 0.0, x0, 0.0, -I_RES, y0)},
        device=device)


def same_io(got, ref, what, device=None):
    """Bit-equal datasets: dims, coordinates, attrs, dtypes and values
    (NaN where NaN); ``device`` is where ``got``'s tensors must be."""
    import torch
    check(dict(got.sizes) == dict(ref.sizes)
          and set(got._variables) == set(ref._variables)
          and set(got._coords) == set(ref._coords), what, 'names')
    for table in ('_variables', '_coords'):
        for k, r in getattr(ref, table).items():
            g = getattr(got, table)[k]
            check(g.dims == r.dims, what, k, g.dims, r.dims)
            if isinstance(r.data, torch.Tensor):
                check(isinstance(g.data, torch.Tensor)
                      and g.data.dtype == r.data.dtype, what, k)
                if device is not None:
                    check(g.data.device.type == device.type, what, k,
                          g.data.device)
                a = g.data.cpu().contiguous()
                b = r.data.cpu().contiguous()
                if a.is_complex():
                    a, b = torch.view_as_real(a), torch.view_as_real(b)
                check(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
                      what, k, 'values')
            else:
                check(np.array_equal(np.asarray(g.data), np.asarray(r.data))
                      and np.asarray(g.data).dtype == np.asarray(r.data)
                      .dtype, what, k)
    check(set(got.attrs) == set(ref.attrs)
          and all(np.array_equal(np.asarray(got.attrs[k]),
                                 np.asarray(ref.attrs[k]))
                  for k in ref.attrs), what, 'attrs')


def run_io_phases(ndt, dev, card, cuda_ms, reset_counts, read_counts, cube,
                  readme_change, tmp):
    """I1-I4: the bench cube written to netCDF and read back onto the
    card, the quick start run from that file, a cut through GeoTIFF,
    zarr and ENVI, and ``align`` of two products written as files. Each
    result is held against the same call on the CPU, exactly. The files
    stay in ``tmp`` (O1 and O3 read ``stack.nc`` and ``cut.tif``).
    Returns the kernel launches of I2's quick start."""
    import torch
    from nd_tpu_torch import io as tio
    from nd_tpu_torch.io import envi, netcdf
    from nd_tpu_torch.ops import conv_cuda
    from nd_tpu_torch.ops.change import change_detection_plain
    from nd_tpu_torch.ops.conv import _separable_factors

    cpu = torch.device('cpu')
    t_io = time.perf_counter()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def mbs(nbytes, secs):
        return nbytes / secs / 1e6

    # ---- I1: the bench cube to netCDF and back onto the card ------------
    ds = io_dataset(cube, NY, NX, device=dev)
    nbytes = sum(v.data.numel() * v.data.element_size()
                 for v in ds._variables.values())
    path = os.path.join(tmp, 'stack.nc')
    _, w_s = timed(lambda: ndt.to_netcdf(ds, path))
    back, r_s = timed(lambda: ndt.open_dataset(path, as_complex=True))
    host, h_s = timed(lambda: ndt.open_dataset(path, as_complex=True,
                                               device='cpu'))
    _, h2d_s = timed(lambda: [v.data.to(dev) for v in
                              host._variables.values()])
    same_io(back, ds, 'I1 card read', dev)
    same_io(host, back, 'I1 CPU read')
    phase('I1', 'bench cube %s as C11, C12 (complex64), C22 + time, '
          'crs, transform -> %s: %s writer, %d MB file; write %.2f s '
          '(%.0f MB/s from the card), read onto the card %.2f s (%.0f '
          'MB/s), read onto the CPU %.2f s, the host-to-device copy of '
          'its tensors %.3f s (%.1f%% of the card read); bit-equal, on '
          'the card, equal to the CPU read | %s'
          % (tuple(cube.shape), os.path.basename(path), netcdf.writer(),
             os.path.getsize(path) // 10 ** 6, w_s, mbs(nbytes, w_s),
             r_s, mbs(nbytes, r_s), h_s, h2d_s, 100.0 * h2d_s / r_s,
             card))
    del host

    # ---- I2: the quick start from the file, counted --------------------
    reset_counts()

    def quick_start():
        qs = ndt.open_dataset(path)
        qs = qs.nd.as_complex()
        flt = ndt.NLMeansFilter(dims=('y', 'x'), r=2, f=1, sigma=2,
                                h=3).apply(qs)
        change = ndt.OmnibusTest(ml=3, alpha=0.01).apply(flt)
        return flt, change
    (flt, change), qs_s = timed(quick_start)
    counts = read_counts()
    method, m_s = timed(lambda: ndt.open_dataset(path).filter.nlmeans(
        r=2, f=1, sigma=2, h=3).nd.change_omnibus(ml=3))
    box = _separable_factors(np.ones((3, 3)) / 9)
    st = torch.stack([flt['C11'].data, flt['C12__re'].data,
                      flt['C12__im'].data, flt['C22'].data])
    looked = conv_cuda.sepconv2_plain(st, box[0], box[1])
    plain = change_detection_plain(looked.permute(1, 2, 3, 0)
                                   .contiguous(), 0.01, n=9)
    mism = int((change.data != plain).sum())
    check(mism == 0, 'I2 mismatches against the plain scan', mism)
    check(change.dims == ('y', 'x', 'time')
          and change.data.device == readme_change.device,
          'I2 change map', change.dims, change.data.device)
    check(torch.equal(change.data, readme_change),
          'I2 change map differs from phase 6\'s')
    check(torch.equal(method.data, change.data),
          'I2 method-style line', method.dims)
    check(all(counts[n] > 0 for n in ('nlmeans', 'omnibus', 'sepconv',
                                      'omnibus_mixed')),
          'I2 launches', counts)
    phase('I2', 'quick start from %s: open_dataset -> as_complex -> '
          'NLMeansFilter(r=2, f=1) -> OmnibusTest(ml=3, alpha=0.01) '
          '%.3f s wall (the read included); %d mismatches vs the plain '
          'scan of the same filtered data; the change map (%d changes) '
          'equals phase 6\'s in-memory chain; README:94\'s method-style '
          'line %.3f s, equal; launches %s | %s'
          % (os.path.basename(path), qs_s, mism, int(change.data.sum()),
             m_s, json.dumps({k: v for k, v in counts.items() if v}),
             card))
    del flt, change, method, st, looked, plain, back

    # ---- I3: a cut through GeoTIFF, zarr and ENVI -------------------------
    cut = io_dataset(cube, I_CUT, I_CUT, device=dev)
    cut_cpu = io_dataset(cube.cpu(), I_CUT, I_CUT, device=cpu)
    real = tio.disassemble_complex(cut)
    bands = torch.cat([real[v].transpose('time', 'y', 'x').data
                       for v in real.data_vars])      # to_geotiff's order
    cut_bytes = bands.numel() * bands.element_size()
    lines = []
    for label, kw in (('GeoTIFF uncompressed strips',
                       dict(compress=False)),
                      ('GeoTIFF deflate 256-px tiles + 2x overview',
                       dict(compress='deflate', tiled=True,
                            tile_size=256, overviews=[2]))):
        p = os.path.join(tmp, 'cut.tif')
        _, w_s = timed(lambda: tio.to_geotiff(real, p, **kw))
        da, r_s = timed(lambda: tio.open_rasterio(p))
        da_cpu = tio.open_rasterio(p, device='cpu')
        check(da.data.device == bands.device, label, da.data.device)
        check(torch.equal(da.data, bands)
              and torch.equal(da_cpu.data, bands.cpu()), label)
        if kw.get('overviews'):
            ov = tio.open_rasterio(p, overview_level=0)
            ov_cpu = tio.open_rasterio(p, overview_level=0, device='cpu')
            check(tuple(ov.shape) == (bands.shape[0], I_CUT // 2,
                                      I_CUT // 2)
                  and torch.equal(ov.data.cpu(), ov_cpu.data),
                  label, 'overview')
        lines.append('%s: write %.0f MB/s, read %.0f MB/s (%.1f MB)'
                     % (label, mbs(cut_bytes, w_s), mbs(cut_bytes, r_s),
                        os.path.getsize(p) / 1e6))
    p = os.path.join(tmp, 'cut.zarr')
    _, w_s = timed(lambda: tio.to_zarr(cut, p))
    z, r_s = timed(lambda: tio.open_zarr(p))
    same_io(z, cut, 'I3 zarr', dev)
    same_io(tio.open_zarr(p, device='cpu'), cut_cpu, 'I3 zarr CPU')
    lines.append('zarr (zlib): write %.0f MB/s, read %.0f MB/s'
                 % (mbs(cut_bytes, w_s), mbs(cut_bytes, r_s)))
    p = os.path.join(tmp, 'cut')
    bands.cpu().numpy().astype('>f4').tofile(p + '.img')
    with open(p + '.hdr', 'w') as fh:
        fh.write('ENVI\nsamples = %d\nlines = %d\nbands = %d\n'
                 'data type = 4\ninterleave = bsq\nbyte order = 1\n'
                 % (I_CUT, I_CUT, bands.shape[0]))
    env, r_s = timed(lambda: torch.from_numpy(
        envi.read_envi(p + '.img').astype(np.float32)).to(dev))
    check(torch.equal(env, bands), 'I3 ENVI')
    lines.append('ENVI (big-endian bsq) read onto the card %.0f MB/s'
                 % mbs(cut_bytes, r_s))
    phase('I3', '%s cut, %d bands, bit-equal on the card and the CPU: '
          '%s | %s' % ((I_CUT, I_CUT, cube.shape[2]), bands.shape[0],
                       '; '.join(lines), card))
    del z, bands, real

    # ---- I4: align two products written as files ------------------------
    shift = I_SHIFT * I_RES
    paths = []
    for name, x0, y0 in (('cube', 5e5, 4e6),
                         ('shifted', 5e5 + shift, 4e6 - shift)):
        paths.append(os.path.join(tmp, name + '.nc'))
        ndt.to_netcdf(io_dataset(cube, I_CUT, I_CUT, x0, y0,
                                 device=dev), paths[-1])
    out_card, out_cpu = (os.path.join(tmp, 'aligned_card'),
                         os.path.join(tmp, 'aligned_cpu'))
    _, a_s = timed(lambda: ndt.warp.align(paths, out_card))
    ndt.warp.Alignment(device='cpu').apply(paths, out_cpu)
    opened = [ndt.open_dataset(p, as_complex=False) for p in paths]
    grid = dict(extent=ndt.warp.get_common_bounds(opened),
                res=ndt.warp.get_common_resolution(opened),
                dst_crs=ndt.warp.get_crs(opened[0]))
    worst = 0.0
    for name, prod in zip(('cube', 'shifted'), opened):
        got = ndt.open_dataset(os.path.join(out_card,
                                            name + '_aligned.nc'))
        mem = ndt.Reprojection(**grid).apply(prod)
        same_io(got, mem, 'I4 %s against Reprojection in memory' % name,
                dev)
        ref = ndt.open_dataset(os.path.join(out_cpu,
                                            name + '_aligned.nc'),
                               device='cpu')
        worst = max(worst, hold_datasets(got, ref, 1e-5, 1e-6,
                                         'I4 %s against the CPU' % name))
    phase('I4', 'align of two %d x %d x %d products written as files '
          '(the second offset by %.2f px): %.2f s (reads, two '
          'reprojections onto %s, writes); the _aligned.nc files read '
          'back equal Reprojection of the same products in memory bit '
          'for bit, and the CPU run within W2\'s rtol 1e-5, atol 1e-6 '
          '(max abs diff %.3g) | %s'
          % (I_CUT, I_CUT, cube.shape[2], I_SHIFT, a_s,
             dict(got.sizes), worst, card))
    phase('I', 'I1-I4 ran %.1f s' % (time.perf_counter() - t_io))
    return counts


# ---- O1-O4: lazy opens and tiling, the quick start through netCDF tiles ----

O_NAMES = ('C11', 'C12__re', 'C12__im', 'C22')
O_BUFFER = 4                # r + f + ml // 2 of the README chain
O3_CHUNK = 256              # O3: 256 x 256 tiles of stack.nc
O1_BAND = 128               # O1: rows a timed classic read takes
O2_SIZE, O2_K, O2_CHUNK = 2048, 4, 512      # bench.py's tile_pipeline
O4_NX = 4096                # O4: 4096 x 4096 x 12, 16x the bench cube's area
O4_CHUNK = 256              # O4: tiles of 256 rows (16 of them)
O4_MIN_ROWS = 1024          # 4096 wide: 805 MB, past the JAX test's 768 MB


def readme_chain(ds):
    """The README chain on one dataset: (filtered, change map)."""
    import nd_tpu_torch as ndt
    flt = ndt.NLMeansFilter(dims=('y', 'x'), r=2, f=1, sigma=2,
                            h=3).apply(ds)
    return flt, ndt.OmnibusTest(ml=3, alpha=0.01).apply(flt)


def readme_plain_change(filtered):
    """The plain version of the README chain's OmnibusTest on a filtered
    (y, x, time, 4) cube: the boxcar multilook, then the float64 scan."""
    from nd_tpu_torch.ops import conv_cuda
    from nd_tpu_torch.ops.change import change_detection_plain
    from nd_tpu_torch.ops.conv import _separable_factors
    taps = _separable_factors(np.ones((3, 3)) / 9)
    looked = conv_cuda.sepconv2_plain(filtered.permute(3, 0, 1, 2)
                                      .contiguous(), taps[0], taps[1])
    return change_detection_plain(looked.permute(1, 2, 3, 0).contiguous(),
                                  0.01, n=9)


def excess_over(got, ref, rtol=1e-5, atol=1e-6):
    """(max abs diff, the largest excess over atol + rtol * |ref|)."""
    diff = (got - ref).abs()
    return float(diff.max()), float((diff - (atol + rtol * ref.abs())).max())


def make_vars(ny, nx, k, dev, seed=SEED, step=2.5):
    """make_cube's covariance cube, drawn on ``dev`` from a torch
    generator (a 3 GB cube from numpy's draws would take most of a
    minute on the host), as four contiguous (y, x, time) variables."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def draw(fn):
        return fn((ny, nx, k), generator=g, device=dev)
    c11 = (1.0 + 0.25 * draw(torch.randn)).abs_() + 0.3
    c22 = (1.0 + 0.25 * draw(torch.randn)).abs_() + 0.3
    mag = 0.4 * torch.sqrt(c11 * c22) * draw(torch.rand)
    ph = (2 * np.pi) * draw(torch.rand)
    c11[:, :, k // 2:] *= step
    c22[:, :, k // 2:] *= step
    return {'C11': c11, 'C12__re': mag * torch.cos(ph),
            'C12__im': mag * torch.sin(ph), 'C22': c22}


def o4_child(src, tiles, outs):
    """O4's measured process: the first tile's window read and run
    through the chain (the warm tile and the reference for the first
    tile's core), then, once the parent that samples its resident set
    answers the 'warm' line, ``tile`` straight from ``src`` and
    ``map_over_tiles`` of the chain, its change maps written to
    ``outs``. After the pass the window's filtered cube and the first
    tile's change map are held against the chain's plain versions.
    Prints one JSON line; the parent checks it."""
    import glob
    import torch
    import nd_tpu_torch as ndt
    from nd_tpu_torch.io.lazy import LazyNetCDFArray
    from nd_tpu_torch.ops import (change_cuda, change_mixed_cuda, conv_cuda,
                                  nlmeans_cuda)
    from nd_tpu_torch.tiling import map_over_tiles, tile
    mods = {'nlmeans': nlmeans_cuda, 'omnibus': change_cuda,
            'sepconv': conv_cuda, 'omnibus_mixed': change_mixed_cuda}
    reads = []
    materialize = LazyNetCDFArray._materialize

    def counted(self, key):
        out = materialize(self, key)
        reads.append(out.nbytes)
        return out
    LazyNetCDFArray._materialize = counted

    lz = ndt.open_dataset(src, chunks={}, rename_latlon=False)
    win = lz.isel(y=slice(0, O4_CHUNK + O_BUFFER))
    x = torch.stack([win[n].data for n in O_NAMES], -1)   # onto the card
    flt, change = readme_chain(win)
    core = change.data[:O4_CHUNK].cpu().numpy()
    filtered = torch.stack([flt[n].data for n in O_NAMES], -1)
    del lz, win, flt, change
    torch.cuda.synchronize()
    print('warm', flush=True)
    sys.stdin.readline()                      # the baseline is taken
    for mod in mods.values():
        mod.reset_launches()
    reads.clear()
    t0 = time.perf_counter()
    tile(src, tiles, chunks={'y': O4_CHUNK}, buffer=O_BUFFER, max_workers=2)
    t1 = time.perf_counter()
    written = map_over_tiles(
        os.path.join(tiles, '*.nc'),
        lambda d: readme_chain(d)[1].to_dataset(name='change'), path=outs,
        merge=False, max_workers=2)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {n: m.launches for n, m in mods.items()}
    first = ndt.open_dataset(
        os.path.join(outs, 'part.y_0_%d.nc' % (O4_CHUNK + O_BUFFER)),
        rename_latlon=False, device='cpu')['change'].transpose(
            'y', 'x', 'time').values != 0
    # the first tile is the window's bytes: the kernels' NLMeans of the
    # window against the plain one, the tile's change map against the
    # plain multilook and scan of that filtered window, at 4096-wide rows
    ref_nl = nlmeans_cuda.nlmeans_spatial_plain(x, (2, 2), (1, 1), 2.0, 3.0)
    nl_diff, nl_excess = excess_over(filtered, ref_nl)
    plain = readme_plain_change(filtered)
    print(json.dumps({
        'tile_s': t1 - t0,
        'map_s': t2 - t1, 'tiles': len(glob.glob(os.path.join(tiles,
                                                                '*.nc'))),
        'written': len(written), 'max_read': max(reads),
        'first_core_equal': bool(np.array_equal(first[:O4_CHUNK], core)),
        'nlmeans_max_diff': nl_diff, 'nlmeans_excess': nl_excess,
        'plain_mismatches': int((torch.from_numpy(first).to(plain.device)
                                 != plain).sum()),
        'launches': launches}))
    return 0


def run_out_of_core_phases(ndt, dev, card, reset_counts, read_counts,
                           readme_filtered, readme_change, tmp):
    """O1-O4: lazy opens of I1's ``stack.nc`` and I3's tiled GeoTIFF,
    bench.py's tile_pipeline configuration, the README chain through
    netCDF tiles of ``stack.nc``, and a cube of 16 times its area
    streamed through the chain in a process whose peak RSS is held.
    Returns the kernel launches of O2, O3 and O4."""
    import glob
    import shutil
    import torch
    from nd_tpu_torch import io as tio
    from nd_tpu_torch.io import netcdf
    from nd_tpu_torch.io.lazy import LazyNetCDFArray
    from nd_tpu_torch.ops import conv_cuda
    from nd_tpu_torch.ops.conv import _separable_factors
    from nd_tpu_torch.testing import generate_test_dataset, run_sampling_rss
    from nd_tpu_torch.tiling import map_over_tiles, tile

    t_o = time.perf_counter()
    path = os.path.join(tmp, 'stack.nc')

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reads = []
    materialize = LazyNetCDFArray._materialize

    def counted(self, key):
        out = materialize(self, key)
        reads.append(out.nbytes)
        return out
    LazyNetCDFArray._materialize = counted
    try:
        # ---- O1: lazy opens read nothing until used, then only a slab ----
        lz, open_s = timed(lambda: ndt.open_dataset(path, chunks={}))
        check(all(lz._variables[n].is_lazy for n in O_NAMES) and not reads
              and lz['C11'].dtype == torch.float32
              and lz.nbytes == 4 * NY * NX * K * 4,
              'O1 lazy open', reads, lz.nbytes)
        win = dict(y=slice(NY * 3 // 8, NY * 3 // 8 + O3_CHUNK),
                   x=slice(NX // 4, NX // 4 + O3_CHUNK))
        sub = lz.isel(win)
        check(not reads and sub._variables['C11'].is_lazy, 'O1 isel read')
        slabs, slab_s = timed(lambda: [sub[n].data for n in O_NAMES])
        eager = ndt.open_dataset(path)
        for n, got in zip(O_NAMES, slabs):
            check(got.device.type == dev.type
                  and torch.equal(got, eager[n].isel(win).data),
                  'O1 slab', n, got.device)
        slab_bytes = O3_CHUNK * O3_CHUNK * K * 4
        check(reads == [slab_bytes] * 4, 'O1 slab reads', reads)
        tif = os.path.join(tmp, 'cut.tif')
        lt = tio.open_rasterio(tif, chunks={})
        check(lt.variable.is_lazy, 'O1 lazy GeoTIFF')
        twin = dict(band=slice(5, 29), y=slice(I_CUT // 5, I_CUT * 7 // 10),
                    x=slice(I_CUT // 14, I_CUT * 3 // 5))
        got = lt.isel(twin).data
        check(got.device.type == dev.type and torch.equal(
            got, tio.open_rasterio(tif).isel(twin).data), 'O1 GeoTIFF window')
        phase('O1', '%s opened with chunks={} in %.4f s reading no variable '
              '(4 lazy, %.0f MB); a %d x %d isel read 4 slabs of %d bytes '
              'onto the card in %.4f s, bit-equal to the eager open; a %s '
              'window of I3\'s tiled deflate GeoTIFF through '
              'open_rasterio(chunks={}) equals the eager read | %s'
              % (os.path.basename(path), open_s, lz.nbytes / 1e6, O3_CHUNK,
                 O3_CHUNK, slab_bytes, slab_s, tuple(got.shape), card))
        del lz, sub, slabs, eager, lt, got

        # the classic reader's two routes, one block of whole rows or a
        # read a row from the window's first to its last column, each
        # timed on a band of rows that nothing has read since the file
        # was written: a tile's reads are first reads, and repeated reads
        # of the same rows run warm and hide the cost of a read call
        from scipy.io import netcdf_file
        widths = (NX, NX // 2, NX // 4, NX // 8, NX // 16)
        bands = iter(range(4 * len(widths)))        # 2 routes x 2 reads
        data = np.random.default_rng(SEED).random(
            (4 * len(widths) * O1_BAND, NX, K), dtype=np.float32)
        rows_nc = os.path.join(tmp, 'rows.nc')
        f = netcdf_file(rows_nc, 'w', version=2)
        for d, n in zip(('y', 'x', 'time'), data.shape):
            f.createDimension(d, n)
        f.createVariable('v', 'f4', ('y', 'x', 'time'))[:] = data
        f.close()
        _, _, _, dtype, shape, begin, stride = \
            netcdf._classic_layout(rows_nc)[2][0]
        call_bytes = netcdf._READ_CALL_BYTES
        timings = []
        low, high = 0, float('inf')
        try:
            for i, cols in enumerate(widths):
                best = {}
                for rep in range(2):
                    for forced in ((1 << 62, -1) if (i + rep) % 2 == 0
                                   else (-1, 1 << 62)):
                        netcdf._READ_CALL_BYTES = forced
                        band = slice(next(bands) * O1_BAND, None)
                        band = slice(band.start, band.start + O1_BAND)
                        t0 = time.perf_counter()
                        out = netcdf._read_classic_slab(
                            rows_nc, begin, stride, shape, dtype,
                            (band, slice(0, cols), slice(None)))
                        secs = time.perf_counter() - t0
                        check(np.array_equal(out, data[band, :cols]),
                              'O1 classic read route', forced, cols)
                        best[forced] = min(best.get(forced, secs), secs)
                block_s, rows_s = best[1 << 62], best[-1]
                timings.append((cols, block_s, rows_s))
                per_call = O1_BAND * (NX - cols) * stride // NX \
                    / (O1_BAND - 1)
                if block_s <= rows_s:
                    low = max(low, per_call)
                else:
                    high = min(high, per_call)
        finally:
            netcdf._READ_CALL_BYTES = call_bytes
        os.remove(rows_nc)
        del data, out
        _, block_s, rows_s = timings[0]
        call_s = (rows_s - block_s) / (O1_BAND - 1)
        rate = O1_BAND * stride / (block_s - call_s)
        phase('O1', 'classic slab reads of %d rows (%d bytes a row) on '
              'first reads, the better of 2, ms as one block / a read a '
              'row, by window width: %s; the faster routes fit a '
              '_READ_CALL_BYTES from %.0f to %.0f bytes (the reader\'s: '
              '%d); at full width a read call costs %.2f us, %.0f bytes at '
              'the block rate of %.0f MB/s | %s'
              % (O1_BAND, stride,
                 ', '.join('%d cols %.3f / %.3f' % (c, b * 1e3, r * 1e3)
                           for c, b, r in timings),
                 low, high, call_bytes, call_s * 1e6, call_s * rate,
                 rate / 1e6, card))

        # ---- O2: bench.py's tile_pipeline configuration -----------------
        tds = generate_test_dataset(dims={'y': O2_SIZE, 'x': O2_SIZE,
                                          'time': O2_K}, device=dev)
        for v in list(tds.data_vars):
            tds[v] = (tds[v].dims, tds[v].data.float())
        box = ndt.BoxcarFilter(w=3)
        reset_counts()
        whole = box.apply(tds)
        per_apply = read_counts()['sepconv']
        box_taps = _separable_factors(np.ones((3, 3)) / 9)
        o2_diff = float((torch.stack([whole[v].transpose(*tds[v].dims).data
                                      for v in tds.data_vars])
                         - conv_cuda.sepconv2_plain(
                             torch.stack([tds[v].data for v in tds.data_vars]),
                             box_taps[0], box_taps[1])).abs().max())
        check(o2_diff == 0, 'O2 whole cube against the plain sepconv',
              o2_diff)
        tdir = os.path.join(tmp, 'o2_tiles')
        n_o2 = (O2_SIZE // O2_CHUNK) ** 2
        reset_counts()
        runs = []
        for _ in range(3):
            shutil.rmtree(tdir, ignore_errors=True)
            os.makedirs(tdir)
            os.sync()
            merged, secs = timed(lambda: (
                tile(tds, tdir, chunks={'y': O2_CHUNK, 'x': O2_CHUNK},
                     buffer=1),
                map_over_tiles(os.path.join(tdir, '*.nc'), box.apply,
                               merge=True, compute=True, max_workers=8))[1])
            runs.append(secs)
        counts_o2 = read_counts()
        for v in tds.data_vars:
            check(torch.equal(merged[v].transpose(*tds[v].dims).data,
                              whole[v].data), 'O2 merge', v)
        check(counts_o2['sepconv'] == 3 * n_o2 * per_apply > 0,
              'O2 launches', counts_o2['sepconv'], per_apply)
        mpix = O2_SIZE * O2_SIZE * O2_K * 4 / 1e6
        phase('O2', 'tile_pipeline: generate_test_dataset %d x %d x %d '
              'float32 (%.0f MB) -> tile(chunks=%d x %d, buffer=1) -> '
              'map_over_tiles(BoxcarFilter(w=3).apply, merge=True, '
              'max_workers=8): %d tiles, best of 3 %.3f s (runs %s), %.2f '
              'Mpix/s; the merge equals BoxcarFilter(w=3) of the whole cube '
              'bit for bit, which equals the plain sepconv of the stacked '
              'variables (max abs diff %g); sepconv launches %d (%d a tile) '
              '| %s'
              % (O2_SIZE, O2_SIZE, O2_K, mpix * 4, O2_CHUNK, O2_CHUNK, n_o2,
                 min(runs), ', '.join('%.3f' % r for r in runs),
                 mpix / min(runs), o2_diff, counts_o2['sepconv'], per_apply,
                 card))
        shutil.rmtree(tdir)
        del tds, whole, merged

        # ---- O3: the quick start per tile of stack.nc -------------------
        o3_tiles = os.path.join(tmp, 'o3_tiles')
        o3_out = os.path.join(tmp, 'o3_out')
        reads.clear()
        _, tile_s = timed(lambda: tile(path, o3_tiles,
                                       chunks={'y': O3_CHUNK, 'x': O3_CHUNK},
                                       buffer=O_BUFFER))
        files = sorted(glob.glob(os.path.join(o3_tiles, '*.nc')))
        n_o3 = (NY // O3_CHUNK) * (NX // O3_CHUNK)
        largest = (O3_CHUNK + 2 * O_BUFFER) ** 2 * K * 4
        check(len(files) == n_o3 and max(reads) == largest,
              'O3 tiles and their reads', len(files), max(reads))
        # tile's reads under its pool by route, the same tiles each time
        # (block, rows, rows, block): the difference in time, less the
        # block route's extra bytes at O1's block rate, over the extra
        # read calls is what a read call costs there
        sides = [min(NY, s + O3_CHUNK + O_BUFFER) - max(0, s - O_BUFFER)
                 for s in range(0, NY, O3_CHUNK)]          # NY == NX
        n_rows = len(O_NAMES) * len(sides) * sum(sides)
        extra_calls = n_rows - len(O_NAMES) * len(sides) ** 2
        extra_bytes = n_rows * NX * K * 4 \
            - len(O_NAMES) * sum(sides) ** 2 * K * 4
        call_bytes = netcdf._READ_CALL_BYTES
        route_s = {1 << 62: [], -1: []}
        o3_route = os.path.join(tmp, 'o3_route')
        try:
            for forced in (1 << 62, -1, -1, 1 << 62):
                netcdf._READ_CALL_BYTES = forced
                shutil.rmtree(o3_route, ignore_errors=True)
                route_s[forced].append(timed(lambda: tile(
                    path, o3_route, chunks={'y': O3_CHUNK, 'x': O3_CHUNK},
                    buffer=O_BUFFER))[1])
        finally:
            netcdf._READ_CALL_BYTES = call_bytes
        shutil.rmtree(o3_route)
        in_pool = (min(route_s[-1]) - min(route_s[1 << 62])
                   + extra_bytes / rate) / extra_calls
        phase('O3', 'tile(stack.nc) under its pool (4 workers) with every '
              'read one block of whole rows: %s s; a read a row (%d more '
              'calls, %d fewer bytes): %s s; a read call there costs %.2f '
              'us, %.0f bytes at O1\'s block rate (the reader\'s '
              '_READ_CALL_BYTES: %d) | %s'
              % (', '.join('%.3f' % t for t in route_s[1 << 62]),
                 extra_calls, extra_bytes,
                 ', '.join('%.3f' % t for t in route_s[-1]),
                 in_pool * 1e6, in_pool * rate, call_bytes, card))
        reset_counts()
        readme_chain(ndt.open_dataset(files[0], rename_latlon=False))
        per_chain = read_counts()

        def chain(d):
            flt, change = readme_chain(d)
            flt['change'] = change
            return flt
        reset_counts()
        merged, map_s = timed(lambda: map_over_tiles(
            files, chain, path=o3_out, merge=True, max_workers=4))
        counts_o3 = read_counts()
        for n in ('nlmeans', 'omnibus', 'sepconv', 'omnibus_mixed'):
            check(per_chain[n] > 0 and counts_o3[n] == n_o3 * per_chain[n],
                  'O3 launches', n, counts_o3[n], per_chain[n])
        got = torch.stack([merged[n].transpose('y', 'x', 'time').data
                           for n in O_NAMES], -1)
        check(got.shape == readme_filtered.shape, 'O3 merged shape',
              tuple(got.shape))
        diff, excess = excess_over(got, readme_filtered)
        check(excess <= 0, 'O3 filtered cube against phase 6', diff)
        change = merged['change'].transpose('y', 'x', 'time').data
        plain = readme_plain_change(got)
        mism = int((change != plain).sum())
        check(change.dtype == torch.bool and mism == 0,
              'O3 change map against the plain scan', change.dtype, mism)
        vs6 = int((change != readme_change).sum())
        phase('O3', 'tile(stack.nc, chunks=%d x %d, buffer=%d) from the path '
              '%.2f s (%d tiles, the largest read %d bytes a variable) -> '
              'map_over_tiles(NLMeansFilter(r=2, f=1) -> OmnibusTest(ml=3, '
              'alpha=0.01), merge=True, max_workers=4) %.2f s: the merged '
              'filtered cube within rtol 1e-5/atol 1e-6 of phase 6\'s (max '
              'abs diff %.3g), the change map %d mismatches vs the plain '
              'scan of the merged cube, %d vs phase 6\'s map; launches %s '
              '(%s a tile) | %s'
              % (O3_CHUNK, O3_CHUNK, O_BUFFER, tile_s, n_o3, max(reads),
                 map_s, diff, mism, vs6,
                 json.dumps({k: v for k, v in counts_o3.items() if v}),
                 json.dumps({k: v for k, v in per_chain.items() if v}),
                 card))
        del merged, got, change, plain
    finally:
        LazyNetCDFArray._materialize = materialize

    # ---- O4: out of core, peak RSS held in a process of its own ---------
    o4 = os.path.join(tmp, 'o4')
    os.makedirs(o4)
    row_bytes = O4_NX * K * 4 * 4
    free = shutil.disk_usage(o4).free
    # the source, its tiles (8 rows of buffer each) and the change maps
    rows = min(O4_NX, int(free / 2.3 / row_bytes) // O4_CHUNK * O4_CHUNK)
    check(rows >= O4_MIN_ROWS, 'O4 disk space', free)
    cube_bytes = rows * row_bytes
    times = np.datetime64('2023-01-03', 'ns') \
        + np.arange(K) * np.timedelta64(12, 'D')
    ds4 = ndt.Dataset(
        {n: (('y', 'x', 'time'), v)
         for n, v in make_vars(rows, O4_NX, K, dev).items()},
        coords={'y': 4e6 - I_RES * (np.arange(rows) + 0.5),
                'x': 5e5 + I_RES * (np.arange(O4_NX) + 0.5), 'time': times},
        device=dev)
    src = os.path.join(o4, 'big.nc')
    _, write_s = timed(lambda: ndt.to_netcdf(ds4, src))
    del ds4
    torch.cuda.empty_cache()
    code = ('import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; '
            'sys.exit(chip_smoke.o4_child(*sys.argv[2:]))')
    root = os.path.dirname(os.path.abspath(__file__))
    rc, out, err, rss_base, rss_peak = run_sampling_rss(
        [sys.executable, '-c', code, root, src, os.path.join(o4, 'tiles'),
         os.path.join(o4, 'out')], timeout=900)
    check(rc == 0 and rss_base > 0, 'O4 process', rc, err[-3000:])
    res = json.loads(out.strip().splitlines()[-1])
    n_o4 = rows // O4_CHUNK
    growth = rss_peak - rss_base
    check(res['tiles'] == n_o4 and res['written'] == n_o4,
          'O4 tiles', res['tiles'], res['written'])
    check(growth < cube_bytes / 2, 'O4 peak RSS growth', growth, cube_bytes)
    check(res['nlmeans_excess'] <= 0, 'O4 first tile\'s NLMeans against '
          'the plain version', res['nlmeans_max_diff'])
    check(res['plain_mismatches'] == 0, 'O4 first tile\'s change map '
          'against the plain scan', res['plain_mismatches'])
    check(res['first_core_equal'], 'O4 first tile against its eager window')
    check(all(res['launches'][n] == n_o4 * per_chain[n]
              for n in res['launches']), 'O4 launches', res['launches'])
    pass_s = res['tile_s'] + res['map_s']
    phase('O4', '%d x %d x %d x 4 float32 cube (%.2f GB, %d MB free) written '
          'by to_netcdf (%s) %.2f s; a process of its own: tile(path, '
          'chunks={y: %d}, buffer=%d, max_workers=2) %.2f s + '
          'map_over_tiles(the README chain, merge=False, max_workers=2) '
          '%.2f s = %.0f MB/s, %d change-map tiles; peak RSS %.0f MB over '
          'a baseline of %.0f MB after the imports and one warm tile '
          '(/proc/<pid>/statm sampled every millisecond from here): +%.0f '
          'MB (limit %.0f MB, half the cube); the largest read %d bytes; '
          'the first tile: NLMeans within rtol 1e-5/atol 1e-6 of the plain '
          'version (max abs diff %.3g), its change map %d mismatches vs '
          'the plain multilook and scan, its core equal to the chain on '
          'its window read whole; launches %s | %s'
          % (rows, O4_NX, K, cube_bytes / 1e9, free // 10 ** 6,
             netcdf.writer(), write_s, O4_CHUNK, O_BUFFER, res['tile_s'],
             res['map_s'], cube_bytes / pass_s / 1e6, res['written'],
             rss_peak / 1e6, rss_base / 1e6, growth / 1e6,
             cube_bytes / 2e6, res['max_read'], res['nlmeans_max_diff'],
             res['plain_mismatches'], json.dumps(res['launches']), card))
    shutil.rmtree(o4)
    counts_o4 = {name: res['launches'].get(name, 0) for name in KERNELS}
    phase('O', 'O1-O4 ran %.1f s' % (time.perf_counter() - t_o))
    return counts_o2, counts_o3, counts_o4


# ---- J1-J4: a Sentinel-2 granule classified on rasterized parcels -----------

J_FIXTURE = os.path.join('tests', 'data', 'torch_s2')
J_ULX, J_ULY = 300000.0, 5500020.0          # tile T33UUP's north-west corner
J_TILE = 10980                              # a tile's 10 m grid, a side
J_PARCELS = 2000                            # J3's polygons on the full grid
J_CHECK_BLOCKS = 10                         # J1: code-blocks a band, Python
J_WINDOWS = 16                              # J3: windows held to the CPU
J_FEATURES = ('B02', 'B03', 'B04', 'B08')


def sha256(arr):
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def run_granule_phases(ndt, dev, card, cuda_ms, reset_counts, read_counts,
                       root):
    """J1-J4: decode the committed granule onto the card, rasterize the
    parcels (and 2,000 polygons on a full tile's grid) on the card, fit
    and apply a classifier on the bands; every result held to
    MANIFEST.json or to the same port call on the CPU. No kernel of the
    port runs on this path: returns the launches counted over J1-J4
    (all 0)."""
    import torch
    from nd_tpu_torch import native
    from nd_tpu_torch.classify import TorchClassifier
    from nd_tpu_torch.core import DataArray, Dataset
    from nd_tpu_torch.io import jp2, open_sentinel2_granule
    from nd_tpu_torch.ops.rasterize import rasterize_values
    from nd_tpu_torch.testing import generate_test_polygons
    from nd_tpu_torch.vector import read_shapefile

    cpu = torch.device('cpu')
    fixture = os.path.join(root, J_FIXTURE)
    with open(os.path.join(fixture, 'MANIFEST.json')) as fh:
        manifest = json.load(fh)
    gdir = os.path.join(fixture, manifest['granule'])
    bands = manifest['bands']
    t_j = time.perf_counter()
    reset_counts()

    # ---- J1: decode ---------------------------------------------------------
    gxx = subprocess.run([native.CXX, '--version'], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    info = native.build_info()
    phase('J1', 'host Tier-1 decoder %s (%s, %s): built=%s in %.2f s'
          % (os.path.basename(info['path']), gxx,
             ' '.join(native.CXX_FLAGS), info['built'], info['seconds']))
    grids = {}
    for res in (10, 20, 60):
        t0 = time.perf_counter()
        ds = open_sentinel2_granule(gdir, resolution=res)
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        names = sorted(ds.data_vars)
        check(names == sorted(b for b, e in bands.items()
                              if e['resolution'] == res), 'J1 bands', res,
              names)
        for b in names:
            check(ds[b].data.device.type == 'cuda', 'J1 on the card', b)
            got = sha256(ds[b].values)
            check(got == bands[b]['reduce']['0']['sha256'], 'J1 sha256', b)
        grids[res] = ds
        phase('J1', 'open_sentinel2_granule(resolution=%d) -> %s %s on the '
              'card in %.3f s (every JP2 of the granule decoded, as the grid '
              'check needs): sha256 equal to MANIFEST.json'
              % (res, names, tuple(ds[names[0]].shape), open_s))
    rng = np.random.RandomState(SEED)
    py_blocks, py_s, rates = 0, 0.0, {}
    paths = {os.path.splitext(f)[0].split('_')[-1]:
             os.path.join(gdir, 'IMG_DATA', f)
             for f in os.listdir(os.path.join(gdir, 'IMG_DATA'))}
    for b in sorted(bands):
        path = paths[b]
        for _ in range(2):                     # the second call is timed
            t0 = time.perf_counter()
            arr = jp2.decode_jp2(path)
            dec_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        jobs = jp2.codeblock_jobs(path)
        t2_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        native_out = jp2._t1_decode_many(jobs, 'native')
        t1_s = time.perf_counter() - t0
        rates[b] = len(jobs) / t1_s
        pick = rng.choice(len(jobs), min(J_CHECK_BLOCKS, len(jobs)),
                          replace=False)
        t0 = time.perf_counter()
        python_out = jp2._t1_decode_many([jobs[i] for i in pick], 'python')
        py_s += time.perf_counter() - t0
        py_blocks += len(pick)
        for i, (pv, pl) in zip(pick, python_out):
            nv, nl = native_out[i]
            check(np.array_equal(nv, pv) and np.array_equal(nl, pl)
                  and nv.dtype == pv.dtype and nl.dtype == pl.dtype,
                  'J1 native against Python Tier-1', b, int(i))
        check(sha256(arr) == bands[b]['reduce']['0']['sha256'], 'J1', b)
        phase('J1', '%s %s %s (%s, %d bytes): decode %.4f s (host); Tier-2 '
              '%.4f s; Tier-1 %d code-blocks in %.4f s native = %.0f '
              'blocks/s (%d threads); %d of them bit-equal (vals, lastp) to '
              '_T1Decoder' % (b, arr.shape, arr.dtype,
                              'reversible 5/3' if bands[b]['reversible']
                              else 'irreversible 9/7', bands[b]['bytes'],
                              dec_s, t2_s, len(jobs), t1_s, rates[b],
                              os.cpu_count() or 1, len(pick)))
    r10 = [rates[b] for b in bands if bands[b]['resolution'] == 10]
    full_blocks = 29000
    phase('J1', 'native Tier-1 on the 10 m bands %.0f-%.0f blocks/s; '
          'extrapolated (not measured): a full 10 m band of about %d '
          'code-blocks would take %.2f-%.2f s of Tier-1 on this host; the '
          'Python _T1Decoder ran %d blocks at %.1f blocks/s (%.0fx slower '
          'than the slowest native band)'
          % (min(r10), max(r10), full_blocks, full_blocks / max(r10),
             full_blocks / min(r10), py_blocks, py_blocks / py_s,
             min(rates.values()) / (py_blocks / py_s)))

    phase('J1', 'ran %.1f s' % (time.perf_counter() - t_j))

    # ---- J2: overviews ------------------------------------------------------
    t_p = time.perf_counter()
    for level in (0, 1):
        for res in (10, 20):
            ov = open_sentinel2_granule(
                gdir, resolution=res, overview_level=level,
                bands=[b for b in bands if bands[b]['resolution'] == res])
            scale = res * 2 ** (level + 1)
            x0 = float(ov['x'].values[0])
            y0 = float(ov['y'].values[0])
            check(ov.attrs['res'] == (float(scale), float(scale))
                  and x0 == J_ULX + scale / 2 and y0 == J_ULY - scale / 2,
                  'J2 grid', level, res, ov.attrs['res'], x0, y0)
            for b in ov.data_vars:
                row = bands[b]['reduce'][str(level + 1)]
                check(list(ov[b].shape) == row['shape']
                      and sha256(ov[b].values) == row['sha256']
                      and ov[b].data.device.type == 'cuda',
                      'J2 sha256', b, level)
            phase('J2', 'overview_level=%d at %d m: %s %s, %g m pixels, '
                  'first centre (%.1f, %.1f): equal to MANIFEST.json at '
                  'reduce %d' % (level, res, sorted(ov.data_vars),
                                 tuple(ov[b].shape), scale, x0, y0,
                                 level + 1))

    phase('J2', 'ran %.1f s' % (time.perf_counter() - t_p))

    # ---- J3: rasterize --------------------------------------------------------
    t_p = time.perf_counter()
    ds10 = grids[10]
    xs = np.asarray(ds10['x'].values)
    ys = np.asarray(ds10['y'].values)
    geoms, records, _ = read_shapefile(os.path.join(fixture,
                                                    manifest['parcels']))
    pairs = [(g, r['class']) for g, r in zip(geoms, records)]
    labels = rasterize_values(pairs, xs, ys, fill=0, device=dev)
    torch.cuda.synchronize()
    labels_cpu = rasterize_values(pairs, xs, ys, fill=0, device=cpu)
    check(labels.device.type == 'cuda' and torch.equal(labels.cpu(),
                                                       labels_cpu),
          'J3 parcels against the CPU')
    small_ms = cuda_ms(lambda: rasterize_values(pairs, xs, ys, fill=0,
                                                device=dev), reps=3,
                       warmup=1)
    counts = torch.bincount(labels_cpu.flatten(), minlength=5).tolist()
    phase('J3', '%d parcels (%d multipart, %d with holes) rasterized onto '
          'the %d x %d 10 m grid on the card in %.3f ms (median of 3): '
          'bit-equal to the CPU route; pixels by class 0-4 %s'
          % (len(geoms), sum(g.geom_type == 'MultiPolygon' for g in geoms),
             sum(bool(getattr(g, 'interiors', [])) for g in geoms),
             len(ys), len(xs), small_ms, counts))
    tx = J_ULX + (np.arange(J_TILE) + 0.5) * 10.0
    ty = J_ULY - (np.arange(J_TILE) + 0.5) * 10.0
    polys = generate_test_polygons(J_PARCELS, extent=(
        J_ULX, J_ULY - J_TILE * 10.0, J_ULX + J_TILE * 10.0, J_ULY),
        random_seed=SEED)
    ids = [(p, i + 1) for i, p in enumerate(polys)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    big = rasterize_values(ids, tx, ty, fill=0, dtype=np.int32, device=dev)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    event_ms = start.elapsed_time(end)
    t0 = time.perf_counter()
    big_cpu = rasterize_values(ids, tx, ty, fill=0, dtype=np.int32,
                               device=cpu)
    cpu_s = time.perf_counter() - t0
    per_poly = torch.bincount(big.flatten().long(), minlength=J_PARCELS + 1)
    per_poly_cpu = torch.bincount(big_cpu.flatten().long(),
                                  minlength=J_PARCELS + 1)
    check(torch.equal(per_poly.cpu(), per_poly_cpu),
          'J3 per-polygon pixel counts against the CPU')
    wrng = np.random.RandomState(SEED + 1)
    for _ in range(J_WINDOWS):
        i, j = wrng.randint(0, J_TILE - 512, 2)
        check(torch.equal(big[i:i + 512, j:j + 512].cpu(),
                          big_cpu[i:i + 512, j:j + 512]), 'J3 window', i, j)
    check(torch.equal(big.cpu(), big_cpu), 'J3 whole raster')
    wall, busy, events, top = profiled(
        lambda: rasterize_values(ids, tx, ty, fill=0, dtype=np.int32,
                                 device=dev))
    burned = per_poly_cpu[1:]
    phase('J3', '%d generate_test_polygons on the %d x %d 10 m grid of '
          'T33UUP (%.0f-%.0f pixels a polygon, %d burned): %.1f ms by CUDA '
          'events, %.1f ms by the host clock (one call); the CPU route '
          '%.2f s; per-polygon counts, %d windows of 512 x 512 and the '
          'whole int32 raster equal to the CPU route | under '
          'torch.profiler wall %.1f ms, device busy %.1f ms (%.1f%%; the '
          'host share %.1f%%), %d device events; top %s | %s'
          % (J_PARCELS, J_TILE, J_TILE, float(burned.min()),
             float(burned.max()), int(burned.sum()), event_ms, host_ms,
             cpu_s, J_WINDOWS, wall, busy, 100.0 * busy / wall,
             100.0 - 100.0 * busy / wall, events,
             ', '.join('%s %.3f ms' % kv for kv in top), card))
    del big, big_cpu

    phase('J3', 'ran %.1f s' % (time.perf_counter() - t_p))

    # ---- J4: classify -------------------------------------------------------
    t_p = time.perf_counter()
    coords = {'y': ys, 'x': xs}
    feats = Dataset({b: (('y', 'x'), ds10[b].data.to(torch.float32))
                     for b in J_FEATURES}, coords=coords, device=dev)
    lab = DataArray(labels, dims=('y', 'x'), coords=coords, device=dev)
    feats_cpu = Dataset({b: (('y', 'x'), feats[b].data.cpu())
                         for b in J_FEATURES}, coords=coords, device=cpu)
    lab_cpu = DataArray(labels_cpu, dims=('y', 'x'), coords=coords,
                        device=cpu)
    short = TorchClassifier(hidden=(16,), epochs=T2_CHECK_EPOCHS,
                            lr=0.05).fit(feats, lab)
    short_cpu = TorchClassifier(hidden=(16,), epochs=T2_CHECK_EPOCHS,
                                lr=0.05).fit(feats_cpu, lab_cpu)
    short_rel = 0.0
    for pair, pair_cpu in zip(short.params, short_cpu.params):
        for a, b in zip(pair, pair_cpu):
            top_d = float((a.cpu() - b).abs().max())
            scale = float(b.abs().max())
            check(top_d <= 1e-4 * scale + 1e-6 and a.device.type == 'cuda',
                  'J4 params at %d epochs' % T2_CHECK_EPOCHS, top_d, scale)
            short_rel = max(short_rel, top_d / scale)
    clf = TorchClassifier(hidden=(16,), epochs=T2_EPOCHS, lr=0.05)
    clf.fit(feats, lab)
    pred = clf.predict(feats)
    torch.cuda.synchronize()
    clf_cpu = TorchClassifier(hidden=(16,), epochs=T2_EPOCHS,
                              lr=0.05).fit(feats_cpu, lab_cpu)
    pred_cpu = clf_cpu.predict(feats_cpu)
    full_rel = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
                   for pair, pair_cpu in zip(clf.params, clf_cpu.params)
                   for a, b in zip(pair, pair_cpu))
    check(pred.data.device.type == 'cuda' and pred.dims == ('y', 'x'),
          'J4 predictions', pred.data.device, pred.dims)
    agree = float((pred.data.cpu() == pred_cpu.data).double().mean())
    check(agree >= 0.999, 'J4 predictions against the CPU', agree)
    known = labels > 0
    accuracy = float((pred.data[known] == labels[known]).double().mean())
    check(accuracy >= 0.9, 'J4 accuracy', accuracy)
    fit_ms = cuda_ms(lambda: TorchClassifier(
        hidden=(16,), epochs=T2_EPOCHS, lr=0.05).fit(feats, lab), reps=3,
        warmup=1)
    predict_ms = cuda_ms(lambda: clf.predict(feats))
    cb = classifier_bound(int(known.sum()), len(J_FEATURES), (16,), 4,
                          T2_EPOCHS)
    phase('J4', 'TorchClassifier(hidden=(16,), epochs=%d, lr=0.05) on %s '
          '(float32, %d x %d) with J3\'s labels (%d labelled pixels, 0 '
          'dropped): at %d epochs params within %.3g of each tensor\'s '
          'largest magnitude of the CPU fit (<= 1e-4, plus 1e-6); at %d '
          'epochs %.3g, predictions of the whole grid equal to the CPU '
          'fit\'s on %.5f%% of pixels (>= 99.9%%); accuracy on the labelled '
          'pixels %.4f' % (T2_EPOCHS, list(J_FEATURES), len(ys), len(xs),
                           int(known.sum()), T2_CHECK_EPOCHS, short_rel,
                           T2_EPOCHS, full_rel, 100.0 * agree, accuracy))
    phase('J4', 'fit %.3f ms (median of 3 after 1 warm-up), predict %.3f ms '
          '(median of 7 after 2) | fit bound %.3f ms (%s), %.1f%% of it | %s'
          % (fit_ms, predict_ms, cb[0], cb[1], 100.0 * cb[0] / fit_ms, card))
    counts_j = read_counts()
    check(not any(counts_j.values()), 'J1-J4 launched a kernel', counts_j)
    phase('J4', 'ran %.1f s' % (time.perf_counter() - t_p))
    phase('J', 'J1-J4 ran %.1f s, no kernel launched' % (
        time.perf_counter() - t_j))
    return counts_j


P_MESH = (2, 2)             # P1-P4: the mesh, every position on the card
P_ODD = (1023, 1021)        # P1: the grid that divides neither mesh axis
P_TIMEOUT = 300             # P5: seconds both worker processes may take


def p5_worker(rank, port, path, out_dir):
    """One of P5's two processes: a gloo group on 127.0.0.1, both on the
    card. Reads only this process's half of ``path`` (a lazy open and an
    ``isel``), holds it as its mesh position's block, sums the cube
    across the processes, runs the multilook (sepconv) and NLMeans r=2,
    f=1 through ``shard_apply`` with the halo rows sent between the
    processes, saves its blocks to ``out_dir`` and prints a JSON line."""
    import torch
    import nd_tpu_torch as ndt
    from nd_tpu_torch.io.lazy import LazyNetCDFArray
    from nd_tpu_torch.ops import conv_cuda, nlmeans_cuda
    from nd_tpu_torch.ops.nlmeans import nlmeans
    from nd_tpu_torch.parallel import distributed, halo, shard_apply

    rank = int(rank)
    dev = torch.device(DEVICE)
    distributed.initialize('127.0.0.1:' + port, num_processes=2,
                           process_id=rank, backend='gloo',
                           local_devices=[dev])
    mesh = distributed.global_mesh()
    check(dict(mesh.shape) == {'y': 2, 'x': 1}, 'P5 mesh', mesh.shape)
    shape = (NY, NX, K, 4)
    sl = distributed.host_local_slices(mesh, shape)
    reads = []
    materialize = LazyNetCDFArray._materialize

    def counted(self, key):
        out = materialize(self, key)
        reads.append(out.nbytes)
        return out
    LazyNetCDFArray._materialize = counted
    part = ndt.open_dataset(path, chunks={}).isel(y=sl['y'], x=sl['x'])
    tile = torch.stack([part[n].data for n in O_NAMES], -1)
    LazyNetCDFArray._materialize = materialize
    cube = distributed.cube_from_process_tiles(tile, mesh, shape)
    total = distributed.all_reduce_sum(torch.stack(
        [b.double().sum() for b in cube.blocks.values()]).sum().reshape(1))
    conv_cuda.reset_launches()
    nlmeans_cuda.reset_launches()
    halo.reset_halo_bytes()
    looked = shard_apply(lambda x: ndt.multilook(x, 3), cube, mesh,
                         {'y': (0, 1), 'x': (1, 1)}, mode='symmetric')
    filtered = shard_apply(
        lambda x: nlmeans(x, (2, 2, 0), (1, 1, 0), 2.0, 3.0), cube, mesh,
        {'y': (0, 3), 'x': (1, 3)}, mode='reflect')
    torch.cuda.synchronize()
    launches = {'sepconv': conv_cuda.launches,
                'nlmeans': nlmeans_cuda.launches}
    exchanged = halo.halo_bytes
    (shard,) = looked.addressable_shards
    (nl_shard,) = filtered.addressable_shards
    np.save(os.path.join(out_dir, 'ml_%d.npy' % rank), shard.data.cpu().numpy())
    np.save(os.path.join(out_dir, 'nl_%d.npy' % rank),
            nl_shard.data.cpu().numpy())
    torch.distributed.destroy_process_group()
    print(json.dumps({
        'rank': rank, 'rows': [shard.index[0].start, shard.index[0].stop],
        'slices': {k: [v.start, v.stop] for k, v in sl.items()},
        'read_bytes': sum(reads), 'sum': float(total[0]),
        'launches': launches, 'halo_bytes': exchanged}), flush=True)
    return 0


def run_sharded_phases(ndt, dev, card, cuda_ms, reset_counts, read_counts,
                       cube, stack, labels, readme_change, tmp):
    """P1-P5: the device mesh on the card. P1 ``shard_apply`` and
    ``apply_sharded`` on a (2, 2) mesh of the card against the unsharded
    calls, P2 the sharded README chain, P3 path A's 3-D NLMeans sharded
    over the long stack, P4 the sharded training step, P5 two processes
    on the card sharing the quick start's file through gloo. Returns the
    launches of P1-P5."""
    import socket
    import torch
    from nd_tpu_torch.core import Dataset
    from nd_tpu_torch.ops import nlmeans_cuda
    from nd_tpu_torch.parallel import (apply_sharded, get_mesh, halo,
                                       shard_apply, sharded_change_detection)

    t_p = time.perf_counter()
    mesh = get_mesh(P_MESH, devices=[dev] * int(np.prod(P_MESH)))
    one = get_mesh()
    check(set(mesh.devices.reshape(-1)) == {dev} and one.size
          == torch.cuda.device_count(), 'P meshes', mesh, one)
    names = O_NAMES
    ds = Dataset({v: (('y', 'x', 'time'), cube[..., i])
                  for i, v in enumerate(names)})
    counts = []

    def max_diff(got, ref):
        if isinstance(ref, torch.Tensor):
            return float((got - ref).abs().max())
        return max(float((got[v].data - ref[v].data).abs().max())
                   for v in ref.data_vars)

    # ---- P1: shard_apply and apply_sharded against the unsharded calls ----
    rng = np.random.RandomState(SEED)
    k33 = rng.rand(3, 3)                      # rank 3: the stencil kernel
    odd = ds.isel(y=slice(0, P_ODD[0]), x=slice(0, P_ODD[1]))
    cases = [
        ('boxcar w=3', ndt.BoxcarFilter(w=3), ds),
        ('gaussian sigma=1.5', ndt.GaussianFilter(sigma=1.5), ds),
        ('convolution 3x3', ndt.ConvolutionFilter(kernel=k33), ds),
        ('nlmeans r=2 f=1', ndt.NLMeansFilter(r=2, f=1, sigma=2, h=3), ds),
        ('boxcar mirror (halo reflect)', ndt.BoxcarFilter(w=3, mode='mirror'),
         ds),
        ('boxcar nearest (halo edge)', ndt.BoxcarFilter(w=3, mode='nearest'),
         ds),
        ('boxcar constant cval=1.5',
         ndt.BoxcarFilter(w=3, mode='constant', cval=1.5), ds),
        ('boxcar wrap', ndt.BoxcarFilter(w=5, mode='wrap'), ds),
        ('boxcar w=3 %dx%d' % P_ODD, ndt.BoxcarFilter(w=3), odd),
        ('convolution 3x3 %dx%d' % P_ODD, ndt.ConvolutionFilter(kernel=k33),
         odd),
        ('nlmeans r=2 f=1 %dx%d' % P_ODD,
         ndt.NLMeansFilter(r=2, f=1, sigma=2, h=3), odd),
    ]
    p1 = {name: 0 for name in KERNELS}
    for label, algo, src in cases:
        reset_counts()
        ref = algo.apply(src)
        torch.cuda.synchronize()
        serial = read_counts()
        reset_counts()
        halo.reset_halo_bytes()
        got = apply_sharded(algo, src, mesh)
        torch.cuda.synchronize()
        sharded = read_counts()
        for name in KERNELS:
            p1[name] += sharded[name]
        ran = {n: c for n, c in sharded.items() if c}
        check(ran and all(sharded[n] == 4 * serial[n] for n in KERNELS),
              'P1 a launch a block', label, serial, sharded)
        diff = max_diff(got, ref)
        check(diff == 0, 'P1 sharded != unsharded', label, diff)
        phase('P1', 'apply_sharded %s on %s: max abs diff %.3g to the '
              'unsharded apply; launches %s (4 x the unsharded); halo bytes '
              '%d' % (label, dict(src.sizes), diff, json.dumps(ran),
                      halo.halo_bytes))
    reset_counts()
    halo.reset_halo_bytes()
    ml_axes = {'y': (0, 1), 'x': (1, 1)}
    got = shard_apply(lambda x: ndt.multilook(x, 3), cube, mesh, ml_axes)
    torch.cuda.synchronize()
    ran = read_counts()
    for name in KERNELS:
        p1[name] += ran[name]
    diff = max_diff(got, ndt.multilook(cube, 3))
    check(diff == 0 and ran['sepconv'] == 4, 'P1 shard_apply multilook',
          diff, ran)
    phase('P1', 'shard_apply(multilook) of the bench cube %s: max abs diff '
          '%.3g, %d sepconv launches, halo bytes %d'
          % (tuple(cube.shape), diff, ran['sepconv'], halo.halo_bytes))
    counts.append(p1)
    for label, algo, src in cases[:4]:
        s_ms = cuda_ms(lambda: apply_sharded(algo, src, mesh))
        u_ms = cuda_ms(lambda: algo.apply(src))
        phase('P1', '%s: sharded %.3f ms, unsharded %.3f ms (x%.2f; CUDA '
              'events, median of 7) | %s' % (label, s_ms, u_ms, s_ms / u_ms,
                                             card))
    s_ms = cuda_ms(lambda: shard_apply(lambda x: ndt.multilook(x, 3), cube,
                                       mesh, ml_axes))
    u_ms = cuda_ms(lambda: ndt.multilook(cube, 3))
    phase('P1', 'multilook: shard_apply %.3f ms, unsharded %.3f ms (x%.2f) '
          '| %s' % (s_ms, u_ms, s_ms / u_ms, card))

    # ---- P2: the README chain sharded, counted -----------------------------
    nlm = ndt.NLMeansFilter(r=2, f=1, sigma=2, h=3)
    omn = ndt.OmnibusTest(ml=3, alpha=0.01)
    reset_counts()
    halo.reset_halo_bytes()
    flt_s = apply_sharded(nlm, ds, mesh)
    ch22 = sharded_change_detection(flt_s, alpha=0.01, ml=3, mesh=mesh)
    torch.cuda.synchronize()
    p2 = read_counts()
    exchanged = halo.halo_bytes
    check(all(p2[n] > 0 for n in ('nlmeans', 'sepconv', 'omnibus',
                                  'omnibus_mixed')), 'P2 kernels', p2)
    counts.append(p2)
    ch11 = sharded_change_detection(flt_s, alpha=0.01, ml=3, mesh=one)
    serial = omn.apply(flt_s)
    flt_u = nlm.apply(ds)
    for label, got in (('(2, 2) mesh', ch22), ('get_mesh() %s'
                                               % dict(one.shape), ch11)):
        m_serial = int((got.data != serial.data).sum())
        m_six = int((got.data != readme_change).sum())
        check(got.dims == ('y', 'x', 'time') and got.data.device == cube.device
              and m_serial == 0 and m_six == 0, 'P2 change map', label,
              m_serial, m_six)
        phase('P2', 'sharded_change_detection on the %s: %d mismatches to '
              'the serial OmnibusTest, %d to phase 6\'s map; %d changes'
              % (label, m_serial, m_six, int(got.data.sum())))
    phase('P2', 'the sharded NLMeans against phase 6\'s: max abs diff %.3g; '
          'launches %s; halo bytes %d' % (max_diff(flt_s, flt_u),
                                          json.dumps(p2), exchanged))
    s_ms = cuda_ms(lambda: sharded_change_detection(
        apply_sharded(nlm, ds, mesh), alpha=0.01, ml=3, mesh=mesh))
    u_ms = cuda_ms(lambda: omn.apply(nlm.apply(ds)))
    phase('P2', 'README chain sharded %.3f ms, unsharded %.3f ms (x%.2f; '
          'CUDA events, median of 7) | %s' % (s_ms, u_ms, s_ms / u_ms, card))
    del flt_s, flt_u, ch22, ch11, serial

    # ---- P3: path A's 3-D NLMeans sharded over the long stack -------------
    ds_long = Dataset({v: (('y', 'x', 'time'), stack[..., i])
                       for i, v in enumerate(names)})
    nlm3 = ndt.NLMeansFilter(dims=('y', 'x', 'time'), r=(2, 2, 1), f=1,
                             sigma=2, h=3)
    ref = nlm3.apply(ds_long)
    reset_counts()
    halo.reset_halo_bytes()
    got = apply_sharded(nlm3, ds_long, mesh)
    torch.cuda.synchronize()
    p3 = read_counts()
    check(p3['nlmeans_3d'] == 4, 'P3 launches', p3)
    counts.append(p3)
    diff = max_diff(got, ref)
    check(diff == 0, 'P3 sharded != unsharded', diff)
    phase('P3', 'apply_sharded(NLMeansFilter(dims=(y, x, time), r=(2, 2, '
          '1), f=1)) on the long stack %s (not cut): max abs diff %.3g to '
          'the unsharded apply; launches %s; '
          'halo bytes %d' % (tuple(stack.shape), diff, json.dumps(
              {n: c for n, c in p3.items() if c}), halo.halo_bytes))
    del got, ref
    s_ms = cuda_ms(lambda: apply_sharded(nlm3, ds_long, mesh), 3, 1)
    u_ms = cuda_ms(lambda: nlm3.apply(ds_long), 3, 1)
    phase('P3', 'sharded %.3f ms, unsharded %.3f ms (x%.2f; CUDA events, '
          'median of 3) | %s' % (s_ms, u_ms, s_ms / u_ms, card))
    del ds_long

    # ---- P4: the sharded training step --------------------------------------
    model = ndt.SARChangePipeline(ml=3, n=1, alpha=0.9)
    p0 = model.init_params(seed=0)
    ref_p, ref_l = model.train_step(p0, cube, labels)
    reset_counts()
    got_p, got_l = model.train_step(p0, cube, labels, mesh=mesh)
    step, data_sh, label_sh = model.make_sharded_step(mesh, shape=(NY, NX))
    vals_s, labs_s = data_sh.place(cube), label_sh.place(labels)
    st_p, st_l = step(p0, vals_s, labs_s)
    torch.cuda.synchronize()
    p4 = read_counts()
    check(p4['sepconv'] == 8 and sum(p4.values()) == 8, 'P4 launches', p4)
    counts.append(p4)

    def hold(label, p, loss, rp, rl):
        l_rel = abs(float(loss) - float(rl)) / abs(float(rl))
        p_ok = all(allclose(p[k], rp[k], 1e-5, 1e-7)[0]
                   for k in ('w', 'b'))
        check(l_rel <= 1e-6 and p_ok, 'P4', label, l_rel)
        return l_rel, max(float((p[k] - rp[k]).abs().max())
                          for k in ('w', 'b'))
    for label, p, loss in (('train_step(mesh=)', got_p, got_l),
                           ('make_sharded_step', st_p, st_l)):
        l_rel, p_abs = hold(label, p, loss, ref_p, ref_l)
        phase('P4', '%s on the (2, 2) mesh: loss %.7f (one device %.7f, '
              'rel diff %.3g <= 1e-6), params max abs diff %.3g (rtol 1e-5, '
              'atol 1e-7 held)' % (label, float(loss), float(ref_l), l_rel,
                                   p_abs))
    ps, pu = p0, p0
    for i in range(3):
        ps, ls = step(ps, vals_s, labs_s)
        pu, lu = model.train_step(pu, cube, labels)
        l_rel, p_abs = hold('step %d' % (i + 1), ps, ls, pu, lu)
        phase('P4', 'step %d: loss %.7f sharded, %.7f one device (rel diff '
              '%.3g), params max abs diff %.3g' % (i + 1, float(ls),
                                                   float(lu), l_rel, p_abs))
    s_ms = cuda_ms(lambda: step(p0, vals_s, labs_s))
    u_ms = cuda_ms(lambda: model.train_step(p0, cube, labels))
    phase('P4', 'sharded step %.3f ms, one-device step (T1\'s call) %.3f ms '
          '(x%.2f; CUDA events, median of 7) | %s'
          % (s_ms, u_ms, s_ms / u_ms, card))
    del vals_s, labs_s

    # ---- P5: two processes on the card, gloo ---------------------------------
    path = os.path.join(tmp, 'stack.nc')
    out_dir = os.path.join(tmp, 'p5')
    os.makedirs(out_dir, exist_ok=True)
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = str(s.getsockname()[1])
    code = ('import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; '
            'sys.exit(chip_smoke.p5_worker(*sys.argv[2:]))')
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, '-c', code, root, str(r), port,
                               path, out_dir], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            left = max(1.0, P_TIMEOUT - (time.perf_counter() - t0))
            try:
                outs.append(p.communicate(timeout=left))
            except subprocess.TimeoutExpired:
                outs.append(('', 'timed out after %d s' % P_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, 'P5 worker', r, p.returncode, err[-3000:])
    res = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    want = float(cube.double().sum())
    ref_ml = ndt.multilook(cube, 3)
    ref_nl = nlmeans_cuda.nlmeans_spatial(cube, (2, 2), (1, 1), 2.0, 3.0)
    half = 4 * (NY // 2) * NX * K * 4
    p5 = {name: 0 for name in KERNELS}
    for r in res:
        rows = slice(*r['rows'])
        ml = torch.from_numpy(np.load(os.path.join(out_dir, 'ml_%d.npy'
                                                   % r['rank']))).to(dev)
        nl = torch.from_numpy(np.load(os.path.join(out_dir, 'nl_%d.npy'
                                                   % r['rank']))).to(dev)
        ml_diff = max_diff(ml, ref_ml[rows])
        nl_d = max_diff(nl, ref_nl[rows])
        check(r['read_bytes'] == half and ml_diff == 0 and nl_d == 0
              and abs(r['sum'] - want) <= 1e-9 * abs(want)
              and r['launches']['sepconv'] >= 1
              and r['launches']['nlmeans'] >= 1, 'P5 rank', r, ml_diff, nl_d)
        for name, c in r['launches'].items():
            p5[name] += c
        phase('P5', 'rank %d: rows %s of stack.nc read lazily (%d bytes, '
              'half the cube), sum over both processes %.6f (the whole '
              'cube\'s %.6f); its block of shard_apply: multilook max abs '
              'diff %.3g, NLMeans r=2 f=1 %.3g to the single process; '
              'launches %s; halo bytes received '
              'through gloo %d' % (r['rank'], r['rows'], r['read_bytes'],
                                   r['sum'], want, ml_diff, nl_d,
                                   json.dumps(r['launches']),
                                   r['halo_bytes']))
    check(res[0]['sum'] == res[1]['sum'], 'P5 sums differ')
    counts.append(p5)
    phase('P5', 'two processes on the card (gloo, tcp://127.0.0.1), both '
          'finished in %.1f s of wall time, imports and CUDA start-up '
          'included' % wall)
    phase('P', 'P1-P5 took %.1f s' % (time.perf_counter() - t_p))
    return tuple(counts)


# ---- V1-V4: tracing, the host oracles, rendering, the last entry points ----

V_FAMILIES = {'nlmeans': 'nlmeans_ring', 'sepconv': 'sepconv_tiled',
              'omnibus': 'omnibus_kernel',
              'omnibus_mixed': 'omnibus_mixed_kernel'}
V_SPANS = {'OmnibusTest.apply': 1, 'data.filter_to_array': 1,
           'data.nlmeans_contiguous': 1, 'data.filter_stack': 1,
           'data.omnibus_in': 1, 'omnibus.kernel': 1, 'omnibus.rescan': 1,
           'omnibus.unpack': 1, 'omnibus.result': 1}   # V1: besides applies
V_CUT = 128                 # V2: bench.py's cpu_baseline cut (128 x 128)
V_TIMEOUT = 300             # V1: seconds the traced child may take


def trace_kernels(logdir, range_name):
    """Parse the one Chrome trace in ``logdir``: (path, the range's host
    span in us, device-busy us inside it, {family: kernel events inside
    the range}, {family: kernel events in the whole trace}); families are
    ``V_FAMILIES``' kernel names. The range is ``annotate``'s host range
    (``user_annotation``); the caller synchronizes inside it, so the
    device work it launched ends inside it too."""
    import glob
    files = glob.glob(os.path.join(logdir, '*.pt.trace.json'))
    check(len(files) == 1, 'one trace file', logdir, files)
    with open(files[0]) as fh:
        events = json.load(fh)['traceEvents']
    ranges = [e for e in events if e.get('name') == range_name
              and e.get('ph') == 'X' and e.get('cat') == 'user_annotation']
    check(len(ranges) == 1, 'the %s range in the trace' % range_name,
          len(ranges))
    t0 = ranges[0]['ts']
    t1 = t0 + ranges[0]['dur']
    device = sorted((e['ts'], e['ts'] + e.get('dur', 0), e['name'])
                    for e in events if e.get('ph') == 'X'
                    and e.get('cat') in ('kernel', 'gpu_memcpy',
                                         'gpu_memset'))
    busy, end = 0.0, t0
    inside = {f: 0 for f in V_FAMILIES}
    total = dict(inside)
    for s, e, name in device:
        for fam, kname in V_FAMILIES.items():
            if kname in name:
                total[fam] += 1
                inside[fam] += t0 <= s and e <= t1
        lo, hi = max(s, end, t0), min(e, t1)
        if hi > lo:
            busy += hi - lo
            end = hi
    return files[0], t1 - t0, busy, inside, total


def v1_child(out_dir):
    """V1's process: the README chain on ``out_dir/cube.npy`` on the card,
    timed without the profiler (median of 5 after a warm-up), then once
    traced (``tracing.start_device_trace`` into ``out_dir/trace``, under
    ``annotate('readme_chain')``, counted), then 5 times under a second
    trace (``out_dir/timed``) to time it with the profiler on. Saves the
    traced call's change map and prints one JSON line."""
    import torch
    import nd_tpu_torch as ndt
    from nd_tpu_torch import tracing
    from nd_tpu_torch.core import Dataset
    from nd_tpu_torch.ops import (change_cuda, change_mixed_cuda,
                                  change_scan_cuda, conv_cuda, nlmeans_cuda)
    mods = {'sepconv': conv_cuda, 'nlmeans': nlmeans_cuda,
            'omnibus': change_cuda, 'omnibus_scan': change_scan_cuda,
            'omnibus_mixed': change_mixed_cuda}
    dev = torch.device(DEVICE)
    cube = torch.from_numpy(np.load(os.path.join(out_dir, 'cube.npy'))).to(
        dev)
    names = ('C11', 'C12__re', 'C12__im', 'C22')
    ds = Dataset({v: (('y', 'x', 'time'), cube[..., i])
                  for i, v in enumerate(names)})
    nlm = ndt.NLMeansFilter(dims=('y', 'x'), r=2, f=1, sigma=2, h=3)
    omn = ndt.OmnibusTest(ml=3, alpha=0.01)

    def chain():
        return omn.apply(nlm.apply(ds))

    def timed():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = chain()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    chain()
    torch.cuda.synchronize()
    plain_ms = statistics.median(timed()[1] for _ in range(5))
    for mod in mods.values():
        mod.reset_launches()
    tracing.reset()
    tracing.start_device_trace(os.path.join(out_dir, 'trace'))
    with tracing.annotate('readme_chain'):
        change, traced_ms = timed()
        torch.cuda.synchronize()
    tracing.stop_device_trace()
    launches = {name: mod.launches for name, mod in mods.items()}
    spans = tracing.report()
    tracing.start_device_trace(os.path.join(out_dir, 'timed'))
    profiled_ms = statistics.median(timed()[1] for _ in range(5))
    tracing.stop_device_trace()
    np.save(os.path.join(out_dir, 'change.npy'), change.data.cpu().numpy())
    print(json.dumps({'launches': launches, 'spans': spans,
                      'plain_ms': plain_ms, 'traced_ms': traced_ms,
                      'profiled_ms': profiled_ms,
                      'device': change.data.device.type}))
    return 0


def cpu_model():
    """The host CPU as /proc/cpuinfo names it (its first processor's
    vendor, model name, family and model) and the cores this process
    sees."""
    fields = {}
    with open('/proc/cpuinfo') as fh:
        for line in fh:
            if not line.strip():
                break
            key, _, value = line.partition(':')
            fields[key.strip()] = value.strip()
    name = ', '.join('%s %s' % (k, fields[k]) for k in (
        'vendor_id', 'model name', 'cpu family', 'model') if k in fields)
    return '%s; %d cores' % (name or 'not named', os.cpu_count() or 0)


def run_visual_phases(ndt, dev, card, cuda_ms, reset_counts, read_counts,
                      cube, exact4, readme_change, readme_filtered, root):
    """V1-V4: the README chain traced in a process of its own, the host
    C++ oracles against the card on bench.py's cpu_baseline cut,
    to_rgb's device part on the card against the CPU (and the rendering
    end to end where cv2 imports), change_detection_hybrid's
    numpy delivery and TorchClassifier.train_step on the card. Returns
    the launches counted in V1's traced call, V2's checked card calls and
    V4's hybrid calls."""
    import importlib
    import tempfile
    import torch
    from nd_tpu_torch import native, visualize
    from nd_tpu_torch.classify import TorchClassifier
    from nd_tpu_torch.ops import change_cuda, nlmeans_cuda
    from nd_tpu_torch.ops.change import (change_detection_exact,
                                         change_detection_hybrid)

    t_v = time.perf_counter()
    counts = []
    # ---- V1: the README chain traced, in a process of its own -------------
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, 'cube.npy'), cube.cpu().numpy())
        code = ('import sys; sys.path.insert(0, sys.argv[1]); '
                'import chip_smoke; sys.exit(chip_smoke.v1_child(sys.argv[2]))')
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, '-c', code, root, tmp],
                              capture_output=True, text=True,
                              timeout=V_TIMEOUT)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, 'V1 child', proc.returncode,
              proc.stderr[-3000:])
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        path, span_us, busy_us, inside, total = trace_kernels(
            os.path.join(tmp, 'trace'), 'readme_chain')
        size = os.path.getsize(path)
        for fam in V_FAMILIES:
            check(inside[fam] == total[fam] == res['launches'][fam] > 0,
                  'V1 %s kernel events in the range' % fam, inside, total,
                  res['launches'])
        check(res['launches']['omnibus_scan'] == 0, 'V1 scan kernel',
              res['launches'])
        spans = {k: v['count'] for k, v in res['spans'].items()}
        check(spans == dict(V_SPANS, **{'NLMeansFilter.apply': 1,
                                        'BoxcarFilter.apply': 1}),
              'V1 spans', spans)
        change = torch.from_numpy(np.load(os.path.join(tmp, 'change.npy')))
        mism = int((change != readme_change.cpu()).sum())
        check(res['device'] == 'cuda' and mism == 0, 'V1 change map',
              res['device'], mism)
    counts.append(dict({n: 0 for n in KERNELS}, **res['launches']))
    phase('V1', 'README chain traced in a child process (%.1f s of wall '
          'time): %s (%d bytes); the readme_chain range holds every kernel '
          'event of the trace, as many as the counters rose: %s; spans %s; '
          '0 mismatches to phase 6\'s map' % (
              wall, os.path.basename(path), size, json.dumps(inside),
              json.dumps(spans)))
    phase('V1', 'device busy %.3f ms of the range\'s %.3f ms (%.1f%%) | '
          'chain by CUDA events: %.3f ms without the profiler (median of 5 '
          'after a warm-up), %.3f ms traced (one call), %.3f ms under a '
          'second window (median of 5): the profiler adds %.3f ms (%.1f%%) '
          '| %s' % (busy_us / 1e3, span_us / 1e3, 100.0 * busy_us / span_us,
                    res['plain_ms'], res['traced_ms'], res['profiled_ms'],
                    res['profiled_ms'] - res['plain_ms'],
                    100.0 * (res['profiled_ms'] / res['plain_ms'] - 1), card))

    # ---- V2: the host C++ oracles against the card ---------------------------
    cut = cube[:V_CUT, :V_CUT].contiguous()
    host = cut.cpu().numpy()
    info = native.oracle_info()
    r, f, sigma, h, alpha, looks = (1, 1, 0), (1, 1, 0), 2.0, 3.0, 0.99, 9

    def best_of_3(fn):
        best, out = None, None
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return out, best
    nl_cpu, t_nl = best_of_3(lambda: native.nlmeans_native(
        host, r, f, sigma, h, -1.0, nthreads=1))
    om_cpu, t_om = best_of_3(lambda: native.change_detection_native(
        host, alpha, n=looks, nthreads=1))
    mpix = V_CUT * V_CUT * K / 1e6
    cpu_rate = mpix * 2 / (t_nl + t_om)
    reset_counts()
    nl_card = nlmeans_cuda.nlmeans_spatial(cut, r[:2], f[:2], sigma, h)
    om_card = change_detection_exact(cut, alpha, n=looks)
    torch.cuda.synchronize()
    counts.append(read_counts())
    check(counts[-1]['nlmeans'] == 1 and counts[-1]['omnibus'] == 1
          and counts[-1]['omnibus_mixed'] == 1, 'V2 launches', counts[-1])
    nl_diff, excess = excess_over(nl_card.cpu(), torch.from_numpy(nl_cpu))
    bad = torch.nonzero(om_card.cpu() != torch.from_numpy(om_cpu))
    if len(bad):
        _, margin = change_cuda.change_detection_fast(
            cut, alpha, n=looks, return_margin=True,
            max_rounds=change_cuda._round_cap(K))
        for y, x, t in bad[:20].tolist():
            phase('V2', 'mismatch at (%d, %d, %d): card %s, oracle %s, '
                  'margin %.3g' % (y, x, t, bool(om_card[y, x, t]),
                                   bool(om_cpu[y, x, t]),
                                   float(margin[y, x])))
    check(excess <= 0 and len(bad) == 0, 'V2 oracles', excess, len(bad))
    nl_ms = cuda_ms(lambda: nlmeans_cuda.nlmeans_spatial(cut, r[:2], f[:2],
                                                         sigma, h))
    om_ms = cuda_ms(lambda: change_detection_exact(cut, alpha, n=looks))
    phase('V2', 'host C++ oracles (%s, %s, built=%s in %.2f s) on the %d x '
          '%d x %d cut: NLMeans r=(1,1,0) f=(1,1,0) within rtol 1e-5, atol '
          '1e-6 of the kernel (largest difference %.3g), change map alpha '
          '%.2f, %d looks: 0 mismatches to the exact mode on the card (%d '
          'changes); launches %s' % (
              os.path.basename(info['path']), ' '.join(native.ORACLE_FLAGS),
              info['built'], info['seconds'], V_CUT, V_CUT, K, nl_diff,
              alpha, looks, int(om_cpu.sum()), json.dumps(counts[-1])))
    phase('V2', 'cpu_1core_mpix_s %.3f (bench.py:1325: 2 x %.3f Mpix over '
          'NLMeans %.3f ms + change %.3f ms, best of 3, one thread, %s) | the '
          'card, the same two calls: NLMeans %.3f ms + exact %.3f ms (CUDA '
          'events, median of 7), %.1f Mpix/s | %s'
          % (cpu_rate, mpix, t_nl * 1e3, t_om * 1e3, cpu_model(), nl_ms,
             om_ms, mpix * 2 / (nl_ms + om_ms) * 1e3, card))

    # ---- V3: rendering --------------------------------------------------------
    c11, c22 = readme_filtered[:, :, 0, 0], readme_filtered[:, :, 0, 3]
    count = readme_change.sum(-1)
    rows = (('C11 / C22 / ratio at t = 0', [c11, c22], True),
            ('the change map\'s count over time', [count], False))
    for label, chans, ratio in rows:
        def image(cs, ratio=ratio):
            return visualize._bgr(cs + [cs[0] / cs[1]] if ratio else cs)
        im = image(chans)
        ref = image([c.cpu() for c in chans])
        check(im.device.type == 'cuda' and im.dtype == torch.uint8
              and torch.equal(im.cpu(), ref), 'V3 %s' % label)
        float_bytes = sum(c.numel() * 8 for c in chans) \
            + (chans[0].numel() * 8 if ratio else 0)
        ms = cuda_ms(lambda: image(chans))
        phase('V3', 'to_rgb\'s device part, %s: the (%d, %d, 3) uint8 image '
              'equal to the CPU\'s bit for bit; %d bytes cross to the host '
              '(and one bool a channel) against %d bytes of float64 '
              'channels; %.3f ms on the card (CUDA events, median of 7) | %s'
              % (label, im.shape[0], im.shape[1], im.numel(), float_bytes,
                 ms, card))
    def importable(name):
        try:
            importlib.import_module(name)
            return True
        except ImportError:
            return False
    missing = [m for m in ('cv2', 'imageio') if not importable(m)]
    check((ndt.to_rgb is None) == ('imageio' in missing)
          and (ndt.write_video is None) == ('imageio' in missing),
          'V3 package-level to_rgb', missing, ndt.to_rgb)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        if 'cv2' in missing:
            for fn, args, text in (
                    (visualize.to_rgb, ([c11],),
                     'this function requires opencv-python (cv2)'),
                    (visualize.render_map, (None,),
                     'render_map requires opencv-python (cv2)')):
                try:
                    fn(*args)
                except ImportError as e:
                    check(str(e) == text, 'V3 ImportError text', str(e))
                else:
                    check(False, 'V3 %s ran without cv2' % fn.__name__)
            done = 'to_rgb and render_map raise the JAX package\'s ' \
                'ImportError texts'
        else:
            ds = io_dataset(readme_filtered, NY, NX)
            chans = [c11, c22, c11 / c22]
            rgb = visualize.to_rgb(chans)
            ref = visualize._bgr([c.cpu() for c in chans[:2]]
                                 + [c11.cpu() / c22.cpu()]).numpy()
            visualize.to_rgb(chans, output=os.path.join(tmp, 'rgb.png'))
            m1 = visualize.render_map(ds)
            m2 = visualize.plot_map(ds, output=os.path.join(tmp, 'map.png'))
            check(np.array_equal(rgb, ref[..., ::-1])
                  and m1.shape == (720, 720, 3)
                  and (visualize.cartopy is not None
                       or np.array_equal(m1, m2)), 'V3 rendering')
            done = 'to_rgb of the card\'s channels (equal to the CPU\'s ' \
                'device part) and to a PNG, render_map and plot_map'
            if 'imageio' in missing:
                try:
                    visualize.write_video(ds, os.path.join(tmp, 'stack.gif'))
                except ImportError as e:
                    check('imageio' in str(e), 'V3 write_video', str(e))
                else:
                    check(False, 'V3 write_video ran without imageio')
                done += '; write_video raises ImportError (no imageio)'
            else:
                visualize.write_video(ds, os.path.join(tmp, 'stack.gif'))
                done += ', write_video to a %d-frame GIF' % K
        sizes = {n: os.path.getsize(os.path.join(tmp, n))
                 for n in sorted(os.listdir(tmp))}
        check(all(sizes.values()), 'V3 files', sizes)
    phase('V3', 'missing on this machine: %s; nd_tpu_torch.to_rgb is %s; %s '
          'end to end in %.2f s; files %s' % (
              ', '.join(missing) or 'nothing', ndt.to_rgb, done,
              time.perf_counter() - t0, json.dumps(sizes)))

    # ---- V4: the remaining entry points ----------------------------------------
    host_cube = cube.cpu().numpy()
    reset_counts()
    hyb = change_detection_hybrid(host_cube, alpha, n=looks)
    hyb_dev = change_detection_hybrid(cube, alpha, n=looks,
                                      return_device=True)
    torch.cuda.synchronize()
    counts.append(read_counts())
    ref4 = exact4.cpu().numpy()
    mism = int((hyb != ref4).sum())
    check(isinstance(hyb, np.ndarray) and hyb.dtype == np.bool_
          and mism == 0, 'V4 hybrid numpy delivery', type(hyb), mism)
    check(hyb_dev.device.type == 'cuda'
          and torch.equal(hyb_dev, exact4), 'V4 hybrid return_device')
    check(counts[-1]['omnibus'] == 2 and counts[-1]['omnibus_mixed'] == 2,
          'V4 launches', counts[-1])
    t0 = time.perf_counter()
    change_detection_hybrid(host_cube, alpha, n=looks)
    hyb_s = time.perf_counter() - t0
    phase('V4', 'change_detection_hybrid on a numpy copy of the bench cube: '
          'a numpy bool map, 0 mismatches to phase 4\'s (%.1f ms of host '
          'clock, the copy onto the card and the bool map back included); '
          'return_device=True: a CUDA tensor equal to it; '
          'launches %s' % (hyb_s * 1e3, json.dumps(counts[-1])))
    X = cube.reshape(NY * NX, K * 4)
    y = exact4.any(-1).reshape(-1).long()
    clf = TorchClassifier(hidden=(16,), lr=0.05)
    start = clf._init_params(K * 4, 2, 'cpu')
    steps = []
    for where in (dev, torch.device('cpu')):
        leaves = [a.to(where).clone().requires_grad_(True)
                  for pair in start for a in pair]
        opt = torch.optim.Adam(leaves, lr=0.05)
        params = [tuple(a.to(where) for a in pair) for pair in start]
        t0 = time.perf_counter()
        steps.append(clf.train_step(params, None, X.to(where), y.to(where),
                                    opt))
        if not steps[1:]:                  # the card's step, timed
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            step_ms = cuda_ms(lambda: clf.train_step(
                params, None, X, y, opt))
    (gp, gs, gl), (rp, rs, rl) = steps
    loss_rel = abs(float(gl) - float(rl)) / abs(float(rl))
    worst = max(float(((g.cpu() - r).abs()
                       - (1e-4 * r.abs().max() + 1e-6)).max())
                for gpair, rpair in zip(gp, rp)
                for g, r in zip(gpair, rpair))
    check(gl.device.type == 'cuda' and loss_rel <= 1e-5 and worst <= 0
          and int(gs['state'][0]['step']) == 1, 'V4 train_step', loss_rel,
          worst)
    phase('V4', 'TorchClassifier(hidden=(16,)).train_step with torch.optim.'
          'Adam on the bench cube as (%d, %d) float32 samples, labels phase '
          '4\'s any-change: loss %.6f, %.3g from the CPU step\'s (rtol '
          '1e-5), parameters within 1e-4 of each tensor\'s largest '
          'magnitude (plus 1e-6); %.3f ms the first step, %.3f ms a step '
          '(CUDA events, median of 7) | %s' % (
              X.shape[0], X.shape[1], float(gl), loss_rel, first_ms, step_ms,
              card))
    phase('V', 'V1-V4 ran %.1f s' % (time.perf_counter() - t_v))
    return tuple(counts)


# the sizes users would call real for the four workflows of
# examples_torch/ (E2-E5): SEVIRI's 3712 x 3712 IR full disk, the bench
# cube's grid, two 1024 x 1024 swaths of 36 dates (a year at 10 days),
# the continental mosaic at 2 km
E_REAL = {'geostationary_disk': dict(n=3712),
          'out_of_core_mosaic': dict(ny=1024, nx=1024, k=12),
          'timeseries_gapfill': dict(ny=1024, nx=1024, k=36),
          'continental_mosaic': dict(res=2000.0)}
E_ORDER = ('geostationary_disk', 'out_of_core_mosaic', 'timeseries_gapfill',
           'continental_mosaic')
E1_CUT = 256                # E1's rows and columns of the bench cube


def same_parts(got, ref, rtol, atol):
    """``ref`` against ``got`` on ``got``'s device, complex results part
    by part: NaN where NaN, +-inf where +-inf, the rest within atol +
    rtol * |ref|; (ok, max abs diff, bit for bit)."""
    import torch
    ref = ref.to(got.device)
    if got.dtype != ref.dtype or got.shape != ref.shape:
        return False, float('inf'), False
    if not (ref.is_floating_point() or ref.is_complex()):
        eq = bool(torch.equal(got, ref))
        return eq, 0.0 if eq else float('inf'), eq
    if ref.is_complex():
        got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    got, ref = got.double(), ref.double()
    nan = got.isnan() & ref.isnan()
    fin = torch.isfinite(ref)
    diff = torch.where(fin, (got - ref).abs(), 0.0)
    ok = bool(((got == ref) | nan | (fin & torch.isfinite(got)
                                     & (diff <= atol + rtol * ref.abs())))
              .all())
    top = float(diff.max()) if diff.numel() else 0.0
    exact = bool(((got == ref) | nan).all())
    return ok, top, exact


def run_fault_phases(dev, card, cube):
    """E1: complex reductions over NaN parts, round, argmax and clip on
    int32, bool and complex payloads and numpy's promotions on a cut of
    the cube on the card, each call against the same call on CPU copies.
    Selections, rounding and element-wise results bit for bit (but the
    float64 power); sums, means and deviations within rtol 1e-5, atol
    1e-6 (complex64) or rtol 1e-12 (complex128): they sum in another
    order."""
    import torch
    from nd_tpu_torch.core import DataArray
    cpu = torch.device('cpu')
    t_e = time.perf_counter()
    rng = np.random.RandomState(SEED + 16)
    cube = cube[:E1_CUT, :E1_CUT]
    c12 = torch.complex(cube[..., 1], cube[..., 2])   # (y, x, t) complex64
    shape = tuple(c12.shape)
    re_nan = torch.from_numpy(rng.rand(*shape) < 0.01).to(dev)
    im_nan = torch.from_numpy(rng.rand(*shape) < 0.01).to(dev)
    c12 = torch.complex(c12.real.masked_fill(re_nan, float('nan')),
                        c12.imag.masked_fill(im_nan, float('nan')))
    c12[5, 7, :] = complex(float('nan'), float('nan'))  # an all-NaN series
    n_checks = 0
    for label, data, tol in (('complex64 %d x %d x %d' % shape, c12,
                              (1e-5, 1e-6)),
                             ('complex128 %d x %d x %d' % shape,
                              c12.to(torch.complex128), (1e-12, 0.0))):
        card_da = DataArray(data, dims=('y', 'x', 'time'))
        cpu_da = DataArray(data.cpu(), dims=('y', 'x', 'time'))
        worst = {}
        for name, dim, exact in (
                ('mean', 'time', False), ('std', 'time', False),
                ('var', 'time', False), ('sum', 'time', False),
                ('median', 'time', True), ('max', 'time', True),
                ('min', 'time', True), ('argmax', 'time', True),
                ('argmin', 'time', True), ('mean', None, False),
                ('max', None, True), ('cumsum', 'time', False),
                ('diff', 'time', True)):
            call = (lambda o: o.diff(dim)) if name == 'diff' \
                else (lambda o: getattr(o, name)(dim))
            got, ref = call(card_da), call(cpu_da)
            check(got.data.device.type == 'cuda', 'E1 on the card', name)
            ok, top, bit = same_parts(got.data, ref.data,
                                      *((0.0, 0.0) if exact else tol))
            check(ok and got.dims == ref.dims and (bit or not exact),
                  'E1', label, name, dim, top)
            worst['%s(%s)' % (name, dim or 'all')] = \
                'bit for bit' if bit else '%.3g' % top
            n_checks += 1
        phase('E1', '%s with NaN parts on the card against the CPU: %s'
              % (label, ', '.join('%s %s' % kv for kv in worst.items())))
    # round, argmax, clip on int32, bool and complex payloads
    c11 = cube[..., 0]
    ints = (c11 * 1000).to(torch.int32)
    mask = c11 > 1.5
    # (label, payload, a second payload or None, call); every result is
    # held bit for bit, but for the power's float64 pow, which the card's
    # math library rounds otherwise (within rtol 1e-14)
    cases = [
        ('int32 round()', ints, None, lambda o, w: o.round()),
        ('int32 round(-2)', ints, None, lambda o, w: o.round(-2)),
        ('bool round()', mask, None, lambda o, w: o.round()),
        ('complex64 round(2)', c12, None, lambda o, w: o.round(2)),
        ('bool argmax(time)', mask, None, lambda o, w: o.argmax('time')),
        ('bool argmin(time)', mask, None, lambda o, w: o.argmin('time')),
        ('int32 argmax(time)', ints, None, lambda o, w: o.argmax('time')),
        ('complex64 clip(0.5, 2+1j)', c12, None,
         lambda o, w: o.clip(0.5, 2 + 1j)),
        ('int32 clip(500, 2000.5)', ints, None,
         lambda o, w: o.clip(500, 2000.5)),
        # numpy's promotions (F13, F13b)
        ('int32 + 1.5', ints, None, lambda o, w: o + 1.5),
        ('int32 ** 0.5', ints, None, lambda o, w: o ** 0.5),
        ('uint16 * 1e-4', (c11 * 1000).to(torch.uint16), None,
         lambda o, w: o * 1e-4),
        ('int32 + float32', ints, c11, lambda o, w: o + w),
        ('int16 * float32', ints.to(torch.int16), c11, lambda o, w: o * w),
        ('bool + float32', mask, c11, lambda o, w: o + w),
        ('complex64 - 1.5 - complex64', c12, c12.flip(0),
         lambda o, w: o - 1.5 - w),
    ]
    dtypes = []
    for label, data, other, fn in cases:
        res = []
        for d in (dev, cpu):
            o = DataArray(data.to(d), dims=('y', 'x', 'time'))
            w = None if other is None else \
                DataArray(other.to(d), dims=('y', 'x', 'time'))
            res.append(fn(o, w))
        got, ref = res
        exact = '**' not in label
        ok, top, bit = same_parts(got.data, ref.data,
                                  0.0 if exact else 1e-14, 0.0)
        check(ok and (bit or not exact) and got.data.device.type == 'cuda',
              'E1', label, top, got.dtype, ref.dtype)
        dtypes.append('%s -> %s%s' % (
            label, str(got.dtype).replace('torch.', ''),
            '' if bit else ' (max abs diff %.3g)' % top))
        n_checks += 1
    expect = {'int32 round()': 'int32', 'bool round()': 'float16',
              'int32 + 1.5': 'float64', 'int32 ** 0.5': 'float64',
              'uint16 * 1e-4': 'float64', 'int32 + float32': 'float64',
              'int16 * float32': 'float32', 'bool + float32': 'float32',
              'int32 clip(500, 2000.5)': 'float64'}
    for line in dtypes:
        label, dt = line.rsplit(' -> ', 1)
        dt = dt.split(' ')[0]
        check(expect.get(label, dt) == dt, 'E1 dtype', label, dt)
    phase('E1', 'round, argmax/argmin, clip and numpy\'s promotions on the '
          'card against the CPU, bit for bit where no difference is '
          'printed: %s' % '; '.join(dtypes))
    phase('E1', '%d calls held in %.1f s | %s'
          % (n_checks, time.perf_counter() - t_e, card))


def load_example(root, name):
    """``examples_torch/<name>.py`` of the checkout at ``root``."""
    import importlib.util
    path = os.path.join(root, 'examples_torch', name + '.py')
    spec = importlib.util.spec_from_file_location('examples_torch_' + name,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(mod, device, sizes, tmp):
    """One workflow's ``main`` on ``device``: (its results as a flat dict
    of dims and payloads, its printed lines, host-clock seconds). The
    out-of-core mosaic's result is the file it writes, read back."""
    import contextlib
    import io
    import torch
    from nd_tpu_torch.io import open_netcdf
    buf = io.StringIO()
    kw = dict(sizes, device=device)
    if mod.__name__.endswith('out_of_core_mosaic'):
        kw['outdir'] = tmp
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(**kw)
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    if 'outdir' in kw:
        lines = [ln.replace(tmp, '<outdir>') for ln in lines]
        out = open_netcdf(os.path.join(out, 'mosaic_3395.nc'), device=device)
    return flat_outputs(out), lines, wall


def flat_outputs(out, prefix=''):
    """``{key: (dims, payload)}`` of every variable and coordinate of a
    workflow's results (tuples, Datasets, DataArrays)."""
    if isinstance(out, tuple):
        flat = {}
        for i, part in enumerate(out):
            flat.update(flat_outputs(part, '%s%d/' % (prefix, i)))
        return flat
    names = list(out.data_vars) if hasattr(out, 'data_vars') else [None]
    flat = {}
    for k in names + list(out.coords):
        da = out if k is None else out[k]
        flat[prefix + (k or '')] = (tuple(da.dims), da.data)
    return flat


def e_cpu_child(root, out_dir):
    """E2-E5's CPU references, in a process of their own beside the
    parent's card runs: every workflow at its default and real sizes on
    the CPU; writes each run's payloads (``.npz``), dims and printed
    lines (``.json``) into ``out_dir``."""
    import tempfile
    sys.path.insert(0, root)
    for name in E_ORDER:
        mod = load_example(root, name)
        for size in ('default', 'real'):
            sizes = E_REAL[name] if size == 'real' else {}
            with tempfile.TemporaryDirectory() as tmp:
                flat, lines, wall = run_example(mod, 'cpu', sizes, tmp)
            tag = os.path.join(out_dir, '%s_%s' % (name, size))
            np.savez(tag + '.npz', **{
                str(i): np.asarray(v[1]) for i, v in enumerate(flat.values())})
            with open(tag + '.json', 'w') as fh:
                json.dump({'keys': list(flat), 'lines': lines, 'wall': wall,
                           'dims': [v[0] for v in flat.values()]}, fh)
    return 0


def run_example_phases(dev, card, reset_counts, read_counts, root):
    """E2-E5: the four runnable workflows of examples_torch/ on the card,
    each at its default size (its printed lines equal to a CPU run's)
    and at the size its users would call real, each result held to a CPU
    run of the same port copy (W2's rtol 1e-5, atol 1e-6, on the card).
    The CPU runs go in a process of their own (``e_cpu_child``) beside
    the card runs. Counted: the launches of each card run. Returns
    them."""
    import tempfile
    import torch

    counts = []
    t_e = time.perf_counter()
    with tempfile.TemporaryDirectory() as ref_dir:
        code = ('import sys; sys.path.insert(0, sys.argv[1]); import '
                'chip_smoke; sys.exit(chip_smoke.e_cpu_child(*sys.argv[1:]))')
        child = subprocess.Popen([sys.executable, '-c', code, root, ref_dir],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        try:
            runs = []
            for name in E_ORDER:
                mod = load_example(root, name)
                for size in ('default', 'real'):
                    sizes = E_REAL[name] if size == 'real' else {}
                    with tempfile.TemporaryDirectory() as tmp:
                        reset_counts()
                        runs.append((name, size, sizes)
                                    + run_example(mod, dev, sizes, tmp))
                        counts.append(read_counts())
            out, err = child.communicate(timeout=600)
        finally:
            if child.poll() is None:
                child.kill()
                child.communicate()
        check(child.returncode == 0, 'E2-E5 CPU references', out[-2000:],
              err[-2000:])
        for i, (name, size, sizes, flat, lines, card_s) in enumerate(runs):
            tag = 'E%d' % (E_ORDER.index(name) + 2)
            stem = os.path.join(ref_dir, '%s_%s' % (name, size))
            with open(stem + '.json') as fh:
                ref = json.load(fh)
            arrays = np.load(stem + '.npz')
            # by name: a merge may list the coordinates in another order
            check(sorted(flat) == sorted(ref['keys']), tag, name, list(flat),
                  ref['keys'])
            top, bit = 0.0, True
            for key, (dims, got) in flat.items():
                j = ref['keys'].index(key)
                want = arrays[str(j)]
                check(list(dims) == ref['dims'][j], tag, name, key, dims)
                if not isinstance(got, torch.Tensor):   # datetimes, strings
                    check(np.array_equal(np.asarray(got), want), tag, name,
                          key)
                    continue
                check(got.device.type == 'cuda', tag, name, key, 'on the card')
                ok, d, exact = same_parts(got, torch.from_numpy(want),
                                          1e-5, 1e-6)
                check(ok, tag, name, size, key, 'rtol 1e-5, atol 1e-6', d)
                top, bit = max(top, d), bit and exact
            if size == 'default':
                check(lines == ref['lines'] and lines, tag, name, lines,
                      ref['lines'])
            launched = {k: v for k, v in counts[i].items() if v}
            if name == 'out_of_core_mosaic':
                check(launched.get('sepconv', 0) > 0, tag,
                      'sepconv launched', launched)
            phase(tag, '%s %s size %s: card %.3f s, the same port copy on '
                  'the CPU %.3f s (host clock, the two side by side in two '
                  'processes); %s; printed lines %s; launches %s | %s'
                  % (name, size, json.dumps(sizes), card_s, ref['wall'],
                     'bit for bit' if bit else
                     'max abs diff %.3g (rtol 1e-5, atol 1e-6 held)' % top,
                     'equal' if lines == ref['lines'] else
                     'differ: %r / %r' % (lines, ref['lines']),
                     json.dumps(launched), card))
            for ln in lines:
                print('  %s | %s' % (tag, ln))
    phase('E2-E5', 'four workflows in %.1f s | %s'
          % (time.perf_counter() - t_e, card))
    return counts


def run_wide_phases(ndt, card, cuda_ms, once_ms, time_rows, reset_counts,
                    read_counts, c11_da, stack, names, err):
    """Phases 15-16: the long-tap kernel (``GaussianFilter`` sigma 16 on
    path C's C11, pass by pass beside the tiled kernel's long-tap route,
    then that route on a long axis beside a short one) and the
    wide-window NLMeans kernel on a 128 x 128 x 56 x 4 slab of the long
    stack. Returns the three runs' launch counts."""
    import torch
    from nd_tpu_torch.core import Dataset
    from nd_tpu_torch.ops import conv_cuda, nlmeans_cuda
    from nd_tpu_torch.ops.conv import gaussian_kernel1d
    ny, nx, kl = c11_da.data.shape
    mpix_l = ny * nx * kl / 1e6
    c11v = c11_da.data.contiguous().reshape(ny, nx, kl, 1)
    # ---- 15. the long-tap kernel, counted -----------------------------------------
    g16 = np.flip(gaussian_kernel1d(16.0))          # 129 taps, as convolve
    gauss16 = ndt.GaussianFilter(dims=('y', 'x', 'time'), sigma=16)

    def pass_views(x):
        """ops/conv.py ``_sep_pass``'s (1, outer, n, inner) view of each
        axis of a (y, x, time) tensor."""
        return [(1, int(np.prod(x.shape[:ax])), x.shape[ax],
                 int(np.prod(x.shape[ax + 1:]))) for ax in range(3)]

    def plain_long(x):
        """The same one-axis passes, each by sepconv's plain version."""
        out = x
        for view in pass_views(x):
            out = conv_cuda.sepconv2_plain(out.contiguous().reshape(view),
                                           np.ones(1), g16).reshape(x.shape)
        return out

    reset_counts()
    smooth16 = gauss16.apply(c11_da)
    torch.cuda.synchronize()
    counts_long = read_counts()
    check(counts_long['sepconv_long_axis'] == 3
          and counts_long['sepconv'] == 0
          and counts_long['sepconv_long'] == 0, 'long-tap kernels',
          counts_long)
    diff = float((smooth16.data - plain_long(c11_da.data)).abs().max())
    check(diff == 0 and smooth16.dims == ('y', 'x', 'time'), 'long taps',
          diff)
    err['sepconv_long_axis'] = diff
    phase(15, 'GaussianFilter(dims=(y,x,time), sigma=16): %d taps per axis, '
          'one pass per axis on the long-tap kernel, max abs diff %.3g vs '
          'the plain passes; launches %s' % (len(g16), diff,
                                             json.dumps(counts_long)))
    del smooth16
    time_rows(15, [
        ('GaussianFilter sigma=16', 'sepconv_long_axis', mpix_l,
         lambda: gauss16.apply(c11_da), lambda: plain_long(c11_da.data),
         sepconv_bound(c11v, g16, g16, g16), None, False)])
    # each pass alone, beside the tiled kernel's long-tap route (the
    # parent's) on the same view, in turns (new, tiled, tiled, new)
    x15 = c11_da.data
    split = []
    for name, view in zip(('y', 'x', 'time'), pass_views(x15)):
        xv = x15.contiguous().reshape(view)
        ref15 = conv_cuda.sepconv2_plain(xv, np.ones(1), g16)
        tiled = conv_cuda.sepconv2_tiled(xv, np.ones(1), g16)
        torch.cuda.synchronize()
        check(float((tiled - ref15).abs().max()) == 0, 'tiled long route',
              name)

        def new_pass(xv=xv):
            return conv_cuda.sepconv2(xv, np.ones(1), g16)

        def old_pass(xv=xv):
            return conv_cuda.sepconv2_tiled(xv, np.ones(1), g16)
        runs = {'new': [], 'old': []}
        for which in ('new', 'old', 'old', 'new'):
            runs[which].append(cuda_ms(new_pass if which == 'new'
                                       else old_pass))
        k_ms, o_ms = min(runs['new']), min(runs['old'])
        bnd = sepconv_bound(xv, g16)
        plan15 = conv_cuda._long_plan(view[1], view[2], view[3], len(g16), 4)
        split.append(k_ms)
        phase(15, 'pass %s %s: long-tap kernel %.3f ms (the tiled route '
              '%.3f ms, x%.2f) | bound %.3f ms (%s), %.1f%% of it; f32 '
              'multiplies and adds issue apart (-fmad=false), so half the '
              'counted rate bounds a bit-equal kernel | plan %s | %s'
              % (name, view, k_ms, o_ms, o_ms / k_ms, bnd[0], bnd[1],
                 100.0 * bnd[0] / k_ms, plan15, card))
        x15 = ref15.reshape(x15.shape)
        del ref15, tiled
    phase(15, 'passes y + x + time: %.3f ms | %s' % (sum(split), card))
    # the tiled route where it still runs: a long axis beside a short one
    t3 = np.array([0.25, 0.5, 0.25])
    xm = c11v.reshape(1, ny, nx, kl)
    reset_counts()
    mixed = conv_cuda.sepconv2(xm, t3, g16)
    torch.cuda.synchronize()
    counts_mixed = read_counts()
    check(counts_mixed['sepconv_long'] == 1 and counts_mixed['sepconv'] == 1
          and counts_mixed['sepconv_long_axis'] == 0, 'mixed long taps',
          counts_mixed)
    diff = float((mixed - conv_cuda.sepconv2_plain(xm, t3, g16)).abs().max())
    check(diff == 0, 'mixed long taps', diff)
    err['sepconv_long'] = diff
    phase(15, 'sepconv2 (1,y,x,56), 3 taps over y beside 129 over x: the '
          'tiled kernel\'s long-tap route, max abs diff %.3g; launches %s'
          % (diff, json.dumps(counts_mixed)))
    time_rows(15, [
        ('sepconv2 3 x 129 taps', 'sepconv_long', mpix_l,
         lambda: conv_cuda.sepconv2(xm, t3, g16),
         lambda: conv_cuda.sepconv2_plain(xm, t3, g16),
         sepconv_bound(xm, t3, g16), None, False)])
    del mixed, x15

    # ---- 16. the wide-window kernel, counted --------------------------------------
    rw, fw = (10, 10, 3), (3, 3, 3)
    slab = stack[:128, :128].contiguous()                 # 128 x 128 x 56 x 4
    plan = nlmeans_cuda._tile_plan(tuple(slab.shape), rw, fw, 4)
    check(plan['route'] == 'wide', 'wide-window kernel', plan)
    nlm_wide = ndt.NLMeansFilter(dims=('y', 'x', 'time'), r=rw, f=3,
                                 sigma=2, h=3)
    ds_slab = Dataset({v: (('y', 'x', 'time'), slab[..., i])
                       for i, v in enumerate(names)})
    reset_counts()
    wide = nlm_wide.apply(ds_slab)
    torch.cuda.synchronize()
    counts_wide = read_counts()
    check(counts_wide['nlmeans_wide'] == 1
          and counts_wide['nlmeans_3d'] == 0, 'wide-window kernels',
          counts_wide)
    wide = torch.stack([wide[v].data for v in names], -1)
    ref_w, wide_plain_ms = once_ms(
        lambda: nlmeans_cuda.nlmeans_3d_plain(slab, rw, fw, 2.0, 3.0))
    diff = (wide - ref_w).abs()
    excess = float((diff - (1e-6 + 1e-5 * ref_w.abs())).max())
    check(bool(torch.isfinite(wide).all()) and excess <= 0, 'wide window',
          excess)
    err['nlmeans_wide'] = float(diff.max())
    phase(16, 'NLMeansFilter(dims=(y,x,time), r=%r, f=3) on %s: plan %s; '
          'max abs diff %.3g, max |diff| / (1e-6 + 1e-5 |ref|) %.3f (rtol '
          '1e-5, atol 1e-6 held); plain once %.1f ms; launches %s'
          % (rw, tuple(slab.shape), plan, err['nlmeans_wide'],
             float((diff / (1e-6 + 1e-5 * ref_w.abs())).max()),
             wide_plain_ms, json.dumps(counts_wide)))
    del wide, ref_w, diff
    time_rows(16, [
        ('nlmeans_3d wide r=(10,10,3) f=3', 'nlmeans_wide',
         slab.numel() / 4 / 1e6,
         lambda: nlmeans_cuda.nlmeans_3d(slab, rw, fw, 2.0, 3.0),
         lambda: nlmeans_cuda.nlmeans_3d_plain(slab, rw, fw, 2.0, 3.0),
         nlmeans_bound(slab, rw, fw), None, True)])
    phase(16, 'nlmeans_3d wide: f32 multiplies and adds issue apart '
          '(-fmad=false), so half the counted rate bounds this kernel | %s'
          % card)
    return counts_long, counts_mixed, counts_wide


def main():
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this '
              'script needs a CUDA device', file=sys.stderr)
        return 2

    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, 'nd_tpu_torch')):
        print('chip_smoke: nd_tpu_torch/ is not beside this script; run it '
              'from a checkout of the repository', file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import nd_tpu_torch as ndt
    import torch.nn.functional as F
    from nd_tpu_torch import _build
    from nd_tpu_torch.core import Dataset
    from nd_tpu_torch.ops import (change_cuda, change_mixed_cuda,
                                  change_scan_cuda, conv_cuda, nlmeans_cuda,
                                  stencil_cuda, stream_cuda)
    from nd_tpu_torch.ops.change import (change_detection_exact,
                                         change_detection_plain,
                                         decision_tables, pack_flags)
    from nd_tpu_torch.ops.conv import (_separable_factors, gaussian_kernel1d,
                                       pad_reflect)

    modules = {'conv_cuda': conv_cuda, 'nlmeans_cuda': nlmeans_cuda,
               'change_cuda': change_cuda,
               'change_scan_cuda': change_scan_cuda,
               'change_mixed_cuda': change_mixed_cuda,
               'stream_cuda': stream_cuda, 'stencil_cuda': stencil_cuda}

    def reset_counts():
        for mod in modules.values():
            mod.reset_launches()

    def read_counts():
        return {name: getattr(modules[mod], attr)
                for name, (_, _, mod, attr) in KERNELS.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # ---- 1. card and build ----------------------------------------------
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    info = _build.build_info()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in info['log'].splitlines()
            if 'registers' in ln or 'spill' in ln]
    phase(1, 'card %s | torch %s cuda %s | kernels built=%s in %.1f s '
          '(%s) from %s' % (card, torch.__version__, torch.version.cuda,
                            info['built'], build_s,
                            os.path.basename(info['path']),
                            ', '.join(info['sources'])))
    for ln in regs:
        print('  ptxas: ' + ln)

    # ---- 2. the cube ------------------------------------------------------
    t0 = time.perf_counter()
    cube = torch.from_numpy(make_cube(NY, NX, K)).to(dev)
    torch.cuda.synchronize()
    phase(2, 'cube %s %s on %s in %.1f s' % (tuple(cube.shape), cube.dtype,
                                            torch.cuda.get_device_name(0),
                                            time.perf_counter() - t0))

    # ---- 3. kernels against their plain versions ---------------------------
    err = {name: 0.0 for name in KERNELS}
    row_ms = {}
    ml_kernel = np.ones((3, 3), np.float32) / 9            # multilook
    ml_taps = _separable_factors(np.flip(ml_kernel))
    box_taps = _separable_factors(np.ones((3, 3)) / 9)     # BoxcarFilter
    x_ml = cube.reshape(1, NY, NX, K * 4)
    x_stack = cube.permute(3, 0, 1, 2).contiguous()        # (4, y, x, t)
    for label, x, taps in (('(y,x,t,4) axes (0,1)', x_ml, ml_taps),
                           ('(4,y,x,t) axes (1,2)', x_stack, box_taps)):
        got = conv_cuda.sepconv2(x, taps[0], taps[1])
        ref = conv_cuda.sepconv2_plain(x, taps[0], taps[1])
        torch.cuda.synchronize()
        diff = float((got - ref).abs().max())
        check(diff == 0, 'sepconv', label, diff)
        err['sepconv'] = max(err['sepconv'], diff)
        phase(3, 'sepconv %s: max abs diff %.3g' % (label, diff))
    for r, f in ((1, 1), (2, 2), (2, 1)):
        got = nlmeans_cuda.nlmeans_spatial(cube, (r, r), (f, f), 2.0, 3.0)
        ref = nlmeans_cuda.nlmeans_spatial_plain(cube, (r, r), (f, f), 2.0,
                                                 3.0)
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        excess = float((diff - (1e-6 + 1e-5 * ref.abs())).max())
        check(bool(torch.isfinite(got).all()) and excess <= 0, 'nlmeans',
              r, f, excess)
        err['nlmeans'] = max(err['nlmeans'], float(diff.max()))
        phase(3, 'nlmeans r=%d f=%d: max abs diff %.3g (rtol 1e-5, atol '
              '1e-6 held)' % (r, f, float(diff.max())))
    # ragged shapes: no tile shape divides them
    rag = torch.from_numpy(make_cube(37, 53, 5, seed=4)).to(dev)
    got = nlmeans_cuda.nlmeans_3d(rag, (2, 2, 1), (1, 1, 1), 2.0, 3.0)
    ref = nlmeans_cuda.nlmeans_3d_plain(rag, (2, 2, 1), (1, 1, 1), 2.0, 3.0)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    excess = float((diff - (1e-6 + 1e-5 * ref.abs())).max())
    check(bool(torch.isfinite(got).all()) and excess <= 0, 'nlmeans_3d '
          'ragged', excess)
    err['nlmeans_3d'] = float(diff.max())
    rag4 = torch.from_numpy(make_cube(37, 53, 7, seed=5)).to(dev).permute(
        3, 0, 1, 2).contiguous()                         # (4, 37, 53, 7)
    got = conv_cuda.sepconv2(rag4, box_taps[0], box_taps[1])
    ref = conv_cuda.sepconv2_plain(rag4, box_taps[0], box_taps[1])
    torch.cuda.synchronize()
    sdiff = float((got - ref).abs().max())
    check(sdiff == 0, 'sepconv ragged', sdiff)
    phase(3, 'ragged: nlmeans_3d at %s max abs diff %.3g (rtol 1e-5, atol '
          '1e-6 held); sepconv at %s max abs diff %.3g'
          % (tuple(rag.shape), float(diff.max()), tuple(rag4.shape), sdiff))
    del rag, rag4, got, ref, diff
    small40 = torch.from_numpy(make_cube(256, 256, 40, seed=1,
                                         burst=True)).to(dev)
    small48 = torch.from_numpy(make_cube(256, 256, 48, seed=2,
                                         burst=True)).to(dev)

    def capped(k):
        return dict(return_margin=True, max_rounds=change_cuda._round_cap(k))
    for label, vals, kw in (
            ('k=12 uncapped', cube, {}),
            ('k=12 capped+margins', cube, capped(K)),
            ('k=40 uncapped', small40, {}),
            ('k=40 capped+margins', small40, capped(40)),
            ('k=48 capped+margins', small48, capped(48))):
        k = vals.shape[2]
        out = change_cuda.change_detection_fast(vals, 0.99, n=9,
                                                return_packed=True, **kw)
        got = out[0] if kw else out
        c_tab, s_tab = change_cuda.omnibus_tables(k, 9, 0.99)
        ref = change_cuda.omnibus_plain(
            vals, c_tab, s_tab, 9.0, kw.get('max_rounds', k - 1),
            bool(kw))
        torch.cuda.synchronize()
        mism = int((got != ref[0]).sum())
        check(mism == 0, 'omnibus flags', label, mism)
        line = 'omnibus round kernel %s (plan %s): flag planes bit-equal' % (
            label, change_cuda._round_plan(k, vals.shape[0] * vals.shape[1]))
        if kw:
            mism = int((out[1].view(torch.int32)
                        != ref[1].view(torch.int32)).sum())
            check(mism == 0, 'omnibus margins', label, mism)
            line += ', margins bit-equal (%d of them -inf)' % int(
                torch.isneginf(ref[1]).sum())
        phase(3, line)
    flags40 = torch.rand((NY, NX, 40), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev) > 0.7
    packed40 = pack_flags(flags40)
    check(packed40.shape[0] == 2
          and bool((change_cuda.unpack_flags(packed40, 40) == flags40).all()),
          'unpack_flags round trip at k=40')
    phase(3, 'unpack_flags round trip at k=40 (2 planes): exact')
    del small40, small48, flags40, packed40

    def check_mixed(label, rows, alpha, n, mode, at=3):
        """The rescan kernel against its plain version on the same rows:
        0 flag mismatches for 'mixed' and 'float64', a rate <= 1e-5 for
        'float32'. Returns the kernel's planes."""
        got = change_mixed_cuda.mixed_scan(rows, alpha, n, mode)
        ref = change_mixed_cuda.mixed_scan_plain(rows, alpha, n, mode)
        torch.cuda.synchronize()
        k = rows.shape[1]
        diff = change_cuda.unpack_flags(got, k) \
            != change_cuda.unpack_flags(ref, k)
        mism = int(diff.sum())
        if mode == 'float32':
            check(mism <= 1e-5 * diff.numel(), 'omnibus_mixed', label, mism)
        else:
            check(mism == 0, 'omnibus_mixed', label, mism)
            err['omnibus_mixed'] = max(err['omnibus_mixed'], float(mism > 0))
        phase(at, 'omnibus_mixed %s: %d mismatches of %d flags (%d set)'
              % (label, mism, diff.numel(),
                 int(change_cuda.unpack_flags(ref, k).sum())))
        return got

    def degenerate_rows(k, seed):
        """1088 rows gathered from a 32 x 34 cube with the bursty column
        (every 34th row), exact zero determinants (row 1, steps 0, 3, 6
        and 9: a log of -inf flags every window that holds one), negative
        ones (row 2, every other step), a NaN (row 3) and a constant
        series (row 4)."""
        rows = make_cube(32, 34, k, seed=seed, burst=True).reshape(-1, k, 4)
        rows[1, 0:12:3] = (1.0, 1.0, 0.0, 1.0)
        rows[2, 1::2, 1] = 3.0
        rows[3, k // 2, 0] = np.nan
        rows[4] = rows[4, 0]
        return torch.from_numpy(rows).to(dev)

    for k in (2, 12, 48, 56, 200, 300):
        rows = degenerate_rows(k, seed=10 + k)
        check_mixed('k=%d N=1088 float32 rows, mixed' % k, rows, 0.99, 9,
                    'mixed')
        if k in (12, 56, 200):
            rows64 = rows.double()
            check_mixed('k=%d N=1088 float64 rows, mixed' % k, rows64, 0.99,
                        9, 'mixed')
            check_mixed('k=%d N=1088 float32 rows, float64' % k, rows, 0.99,
                        9, 'float64')
            check_mixed('k=%d N=1088 float32 rows, float32' % k, rows, 0.99,
                        9, 'float32')
            check_mixed('k=%d N=1088 float64 rows, float32' % k, rows64,
                        0.99, 9, 'float32')
        if k == 56:
            for nrows in (1, 33):
                check_mixed('k=56 N=%d float32 rows, mixed' % nrows,
                            rows[:nrows], 0.99, 9, 'mixed')
            check_mixed('k=56 N=1088 alpha=1e-12, mixed', rows, 1e-12, 9,
                        'mixed')
            check_mixed('k=56 N=1088 float64 rows alpha=1e-12, mixed',
                        rows.double(), 1e-12, 9, 'mixed')
            check(not decision_tables(
                56, 0.5, 0.99, torch.float64)[0], 'unfolded tables')
            check_mixed('k=56 N=1088 n=0.5 (unfolded float64), mixed',
                        rows, 0.99, 0.5, 'mixed')
        if k in (12, 56, 200):
            # the rescan entry point: suspects from margins (NaN every
            # 7th), planes written in place, the others untouched
            gen = torch.Generator(device=dev).manual_seed(k)
            margin = torch.rand(rows.shape[0], generator=gen,
                                device=dev) * 2 - 1
            margin[::7] = float('nan')
            start = torch.randint(0, 2 ** 30, ((k + 30) // 31,
                                               rows.shape[0]),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)
            for vals in (rows, rows.double()):
                got_p, ref_p = start.clone(), start.clone()
                got_n = change_mixed_cuda.rescan(vals, margin, got_p, 0.99,
                                                 9, 1e-4)
                ref_n = change_mixed_cuda.rescan_plain(vals, margin, ref_p,
                                                       0.99, 9, 1e-4)
                torch.cuda.synchronize()
                mism = int((got_p != ref_p).sum())
                check(mism == 0 and int(got_n) == int(ref_n), 'rescan', k,
                      vals.dtype, mism, int(got_n), int(ref_n))
                phase(3, 'rescan k=%d N=1088 %s rows: %d suspects selected '
                      'on the card, planes bit-equal to the plain version'
                      % (k, vals.dtype, int(got_n)))
    del rows, rows64

    # ---- 4-6. the main path, counted ------------------------------------------
    reset_counts()

    exact, suspects = change_detection_exact(cube, 0.99, n=9,
                                             margin_eps=1e-4,
                                             return_count=True)
    mixed = change_detection_plain(cube, 0.99, n=9, stat_dtype='mixed')
    mism = int((exact != mixed).sum())
    check(mism == 0, 'exact omnibus mismatches', mism)
    check(int(exact.sum()) > 0, 'the bench cube shows no change')
    phase(4, 'exact omnibus: %d mismatches vs plain f64 mixed scan; %d '
          'suspects rescanned; %d changes' % (mism, suspects,
                                              int(exact.sum())))
    # T1's labels: changed at any date, the outer ring masked (-1). (Phase
    # 5's map, at alpha 0.9 on the multilooked cube, flags no pixel here.)
    t_labels = exact.any(-1).to(torch.int32)
    t_labels[:T_RING] = -1
    t_labels[-T_RING:] = -1
    t_labels[:, :T_RING] = -1
    t_labels[:, -T_RING:] = -1

    model = ndt.SARChangePipeline(ml=3, n=1, alpha=0.9).to(dev)
    fwd = model(cube)

    def plain_forward(values):
        looked = conv_cuda.sepconv2_plain(
            values.reshape(1, NY, NX, K * 4), ml_taps[0],
            ml_taps[1]).reshape(values.shape)
        return change_detection_plain(looked, 0.9, n=9)

    ref = plain_forward(cube)
    mism = int((fwd != ref).sum())
    check(fwd.shape == (NY, NX, K) and fwd.dtype == torch.bool,
          'pipeline forward output', fwd.shape, fwd.dtype)
    check(mism == 0, 'pipeline forward mismatches', mism)
    phase(5, 'SARChangePipeline.forward: %d mismatches vs plain path; %d '
          'changes' % (mism, int(fwd.sum())))

    names = ('C11', 'C12__re', 'C12__im', 'C22')
    ds = Dataset({v: (('y', 'x', 'time'), cube[..., i])
                  for i, v in enumerate(names)})
    nlm = ndt.NLMeansFilter(dims=('y', 'x'), r=2, f=1, sigma=2, h=3)
    omn = ndt.OmnibusTest(ml=3, alpha=0.01)
    flt = nlm.apply(ds)
    change = omn.apply(flt)
    stacked = torch.stack([flt[v].data for v in names], -1)
    ref_nl = nlmeans_cuda.nlmeans_spatial_plain(cube, (2, 2), (1, 1), 2.0,
                                                3.0)
    excess = float(((stacked - ref_nl).abs()
                    - (1e-6 + 1e-5 * ref_nl.abs())).max())
    check(excess <= 0, 'README NLMeans', excess)

    def plain_omnibus(fds):
        st = torch.stack([fds[v].data for v in names])       # (4, y, x, t)
        looked = conv_cuda.sepconv2_plain(st, box_taps[0], box_taps[1])
        return change_detection_plain(
            looked.permute(1, 2, 3, 0).contiguous(), 0.01, n=9)

    ref_ch = plain_omnibus(flt)
    mism = int((change.data != ref_ch).sum())
    check(change.dims == ('y', 'x', 'time')
          and change.data.device == cube.device, 'README change map',
          change.dims, change.data.device)
    check(mism == 0, 'README omnibus mismatches', mism)
    readme_change = change.data              # I2 reads the same map
    readme_filtered = stacked                # O3 reads the same cube
    phase(6, 'README chain: NLMeans within rtol 1e-5/atol 1e-6 of plain; '
          'OmnibusTest %d mismatches vs plain scan of the same filtered '
          'data; %d changes' % (mism, int(change.data.sum())))

    # ---- 7. the path went through every kernel ----------------------------------
    launches = read_counts()
    check(all(launches[n] > 0 for n in ('sepconv', 'nlmeans', 'omnibus',
                                        'omnibus_mixed')),
          'a kernel of the path was not launched', launches)
    phase(7, 'launches in phases 4-6: %s' % json.dumps(launches))

    # ---- 8. times ------------------------------------------------------------
    def cuda_ms(fn, reps=7, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def expand_stack(arr):
        return Dataset({v: (('y', 'x', 'time'), arr[..., i])
                        for i, v in enumerate(names)})

    def cudnn_valid(x, taps):
        """The library yardstick of a sepconv call: cuDNN's depthwise
        convolution (TF32 off) over ``x`` already padded as the kernel
        pads it, so only the VALID part is timed. Two tap vectors: x is
        (outer, n0, n1, inner), inner the channels (an NHWC view);
        three: x is (n0, n1, n2, 1). Returns (call, output as x's
        layout)."""
        vecs = [np.ravel(np.asarray(t, np.float64)) for t in taps]
        pads = [((len(t) - 1) // 2, len(t) // 2) for t in vecs]
        if len(vecs) == 2:
            xin = pad_reflect(x, [(0, 0)] + pads + [(0, 0)]).permute(
                0, 3, 1, 2)
            c = x.shape[3]
            w = torch.tensor(np.outer(*vecs), dtype=x.dtype, device=x.device)
            w = w.expand(c, 1, *w.shape).contiguous()
            return (lambda: F.conv2d(xin, w, groups=c),
                    lambda out: out.permute(0, 2, 3, 1))
        xin = pad_reflect(x, pads + [(0, 0)])[..., 0][None, None]
        w = torch.tensor(np.einsum('i,j,k->ijk', *vecs), dtype=x.dtype,
                         device=x.device)[None, None]
        return (lambda: F.conv3d(xin, w), lambda out: out[0, 0, ..., None])

    def yardstick(x, taps, got):
        """(call, ms check): the yardstick, checked to compute the same
        function (1e-5 max|x|; its products round otherwise)."""
        call, layout = cudnn_valid(x, taps)
        diff = float((layout(call()) - got).abs().max())
        check(diff <= 1e-5 * float(x.abs().max()), 'cuDNN yardstick', diff)
        return call

    def time_rows(n, rows):
        """Time each row (plain, kernel, kernel, plain: both see the same
        card state) and print it with its bound and yardstick."""
        for label, key, mp, kern, plain, bnd, lib, slow in rows:
            reps, warm = (3, 1) if slow else (7, 2)
            if plain is None:
                k_ms, p_ms = cuda_ms(kern, reps, warm), float('nan')
            else:
                p1 = cuda_ms(plain, 1, 0) if slow else cuda_ms(plain, reps,
                                                               warm)
                k1 = cuda_ms(kern, reps, warm)
                k2 = cuda_ms(kern, reps, warm)
                p2 = cuda_ms(plain, 1, 0) if slow else cuda_ms(plain, reps,
                                                               warm)
                k_ms, p_ms = min(k1, k2), min(p1, p2)
            lib_ms = cuda_ms(lib, reps, warm) if lib is not None else None
            line = '%-28s kernel %9.3f ms %9.1f Mpix/s | plain %9.3f ms ' \
                '%9.1f Mpix/s | x%.2f' % (label, k_ms, mp / k_ms * 1e3, p_ms,
                                          mp / p_ms * 1e3, p_ms / k_ms)
            if bnd is not None:
                line += ' | bound %.3f ms (%s), %.1f%% of it' % (
                    bnd[0], bnd[1], 100.0 * bnd[0] / k_ms)
            if lib_ms is not None:
                line += ' | library call %.3f ms' % lib_ms
            phase(n, line + ' | ' + card)
            if key:
                row_ms[key] = {'ms': k_ms, 'plain_ms': p_ms,
                               'bound_ms': bnd[0], 'bound_by': bnd[1],
                               'library_ms': lib_ms}

    mpix = NY * NX * K / 1e6
    cap = change_cuda._round_cap(K)
    rows4 = cube.reshape(-1, K, 4)
    packed4, margin4 = change_cuda.change_detection_fast(
        cube, 0.99, n=9, return_margin=True, return_packed=True,
        max_rounds=cap)
    plain4 = packed4.clone()
    idx4 = torch.nonzero(~(margin4 > 1e-4).reshape(-1)).squeeze(1)
    planes4 = change_mixed_cuda.mixed_scan(rows4.index_select(0, idx4), 0.99,
                                           9)
    ml_got = conv_cuda.sepconv2(x_ml, *ml_taps)
    st_got = conv_cuda.sepconv2(x_stack, *box_taps)
    timed = [
        # label, key, Mpix, kernel, plain, bound, yardstick, plain once
        ('sepconv (y,x,t,4)', 'sepconv', mpix,
         lambda: conv_cuda.sepconv2(x_ml, *ml_taps),
         lambda: conv_cuda.sepconv2_plain(x_ml, *ml_taps),
         sepconv_bound(x_ml, *ml_taps), yardstick(x_ml, ml_taps, ml_got),
         False),
        ('sepconv (4,y,x,t)', None, mpix,
         lambda: conv_cuda.sepconv2(x_stack, *box_taps),
         lambda: conv_cuda.sepconv2_plain(x_stack, *box_taps),
         sepconv_bound(x_stack, *box_taps),
         yardstick(x_stack, box_taps, st_got), False),
        ('nlmeans r=1 f=1', None, mpix,
         lambda: nlmeans_cuda.nlmeans_spatial(cube, (1, 1), (1, 1), 2., 3.),
         lambda: nlmeans_cuda.nlmeans_spatial_plain(cube, (1, 1), (1, 1),
                                                    2., 3.),
         nlmeans_bound(cube, (1, 1, 0), (1, 1, 0)), None, False),
        ('nlmeans r=2 f=2', None, mpix,
         lambda: nlmeans_cuda.nlmeans_spatial(cube, (2, 2), (2, 2), 2., 3.),
         lambda: nlmeans_cuda.nlmeans_spatial_plain(cube, (2, 2), (2, 2),
                                                    2., 3.),
         nlmeans_bound(cube, (2, 2, 0), (2, 2, 0)), None, False),
        ('nlmeans r=2 f=1', 'nlmeans', mpix,
         lambda: nlmeans_cuda.nlmeans_spatial(cube, (2, 2), (1, 1), 2., 3.),
         lambda: nlmeans_cuda.nlmeans_spatial_plain(cube, (2, 2), (1, 1),
                                                    2., 3.),
         nlmeans_bound(cube, (2, 2, 0), (1, 1, 0)), None, False),
        ('omnibus fast capped+margins', 'omnibus', mpix,
         lambda: change_cuda.change_detection_fast(
             cube, 0.99, n=9, return_margin=True, return_packed=True,
             max_rounds=cap),
         lambda: change_cuda.omnibus_plain(
             cube, *change_cuda.omnibus_tables(K, 9, 0.99), 9.0, cap,
             True),
         round_bound(cube, change_cuda.change_detection_fast(
             cube, 0.99, n=9, return_margin=True, return_packed=True,
             max_rounds=cap)[0], cap), None, False),
        ('rescan phase 4 from margins', None, idx4.numel() * K / 1e6,
         lambda: change_mixed_cuda.rescan(rows4, margin4, packed4, 0.99, 9,
                                          1e-4),
         lambda: change_mixed_cuda.rescan_plain(rows4, margin4, plain4,
                                                0.99, 9, 1e-4),
         mixed_bound(rows4.index_select(0, idx4), planes4, NY * NX), None,
         False),
        ('phase 4 exact omnibus', None, mpix,
         lambda: change_detection_exact(cube, 0.99, n=9, margin_eps=1e-4),
         lambda: change_detection_plain(cube, 0.99, n=9), None, None,
         False),
        ('phase 5 pipeline forward', None, mpix,
         lambda: model(cube), lambda: plain_forward(cube), None, None,
         False),
        ('phase 6 README chain', None, mpix,
         lambda: omn.apply(nlm.apply(ds)),
         lambda: plain_omnibus(expand_stack(
             nlmeans_cuda.nlmeans_spatial_plain(cube, (2, 2), (1, 1), 2.0,
                                                3.0))), None, None, False),
    ]
    del ml_got, st_got
    time_rows(8, timed)
    del packed4, plain4, planes4
    phase(8, 'peak device memory %.2f GiB | %s'
          % (torch.cuda.max_memory_allocated() / 2 ** 30, card))

    # ---- 9. the long stack: kernels against their plain versions ---------------
    def once_ms(fn):
        """One call timed with CUDA events: (result, ms)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    del x_ml, x_stack, fwd, ref, flt, change, stacked, ref_nl, ref_ch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stack = torch.from_numpy(make_cube(NY, NX, KL, seed=SEED + 3, step=5.0,
                                       burst=True)).to(dev)
    bcube = torch.from_numpy(make_cube(BNY, BNX, BK, seed=SEED + 2,
                                       burst=True)).to(dev)
    torch.cuda.synchronize()
    phase(9, 'long stack %s (%.2f GB) and path-B stack %s (%.2f GB) on the '
          'card in %.1f s' % (tuple(stack.shape), stack.numel() * 4e-9,
                              tuple(bcube.shape), bcube.numel() * 4e-9,
                              time.perf_counter() - t0))

    r3, f3 = (2, 2, 1), (1, 1, 1)
    got = nlmeans_cuda.nlmeans_3d(stack, r3, f3, 2.0, 3.0)
    ref_nl3, nl3_plain_ms = once_ms(
        lambda: nlmeans_cuda.nlmeans_3d_plain(stack, r3, f3, 2.0, 3.0))
    diff = (got - ref_nl3).abs()
    excess = float((diff - (1e-6 + 1e-5 * ref_nl3.abs())).max())
    check(bool(torch.isfinite(got).all()) and excess <= 0, 'nlmeans_3d',
          excess)
    err['nlmeans_3d'] = max(err['nlmeans_3d'], float(diff.max()))
    phase(9, 'nlmeans_3d r=(2,2,1) f=1 at %s: max abs diff %.3g (rtol 1e-5, '
          'atol 1e-6 held); plain version once %.1f ms'
          % (tuple(stack.shape), err['nlmeans_3d'], nl3_plain_ms))
    del got, diff

    for label, vals in (('k=56 %dx%d' % (NY, NX), stack),
                        ('k=200 %dx%d' % (BNY, BNX), bcube)):
        k = vals.shape[2]
        gp, gm = change_scan_cuda.change_detection_scan(vals, 0.99, n=9,
                                                        return_packed=True)
        rp, rm = change_scan_cuda.scan_plain(
            vals, change_scan_cuda.scan_tables(k, 9, 0.99), 9.0)
        torch.cuda.synchronize()
        same_flags = bool((gp == rp).all())
        same_class = bool(((torch.isnan(gm) == torch.isnan(rm))
                           & (torch.isposinf(gm) == torch.isposinf(rm))
                           & (torch.isneginf(gm) == torch.isneginf(rm))).all())
        fin = torch.isfinite(gm) & torch.isfinite(rm)
        mdiff = float((gm[fin] - rm[fin]).abs().max()) if bool(fin.any()) \
            else 0.0
        check(same_flags and same_class and mdiff == 0.0, 'omnibus_scan',
              label, same_flags, same_class, mdiff)
        err['omnibus_scan'] = max(err['omnibus_scan'], mdiff)
        phase(9, 'omnibus_scan %s: flags and margins bit-equal to the plain '
              'version (%d finite margins)' % (label, int(fin.sum())))
        del gp, gm, rp, rm, fin

    c11v = stack[..., 0].contiguous().reshape(NY, NX, KL, 1)
    gauss_taps = gaussian_kernel1d(1.0)
    box3 = _separable_factors(np.ones((3, 3, 3)) / 27)
    for label, taps in (('gaussian sigma=1', (gauss_taps,) * 3),
                        ('boxcar w=3', tuple(box3))):
        got = conv_cuda.sepconv3(c11v, *taps)
        ref3 = conv_cuda.sepconv3_plain(c11v, *taps)
        torch.cuda.synchronize()
        diff = float((got - ref3).abs().max())
        check(diff == 0, 'sepconv3', label, diff)
        err['sepconv3'] = max(err['sepconv3'], diff)
        phase(9, 'sepconv3 %s at %s: max abs diff %.3g'
              % (label, tuple(c11v.shape), diff))
    # path A's multilook: the two-axis kernel on the stacked variables
    x_stack_l = stack.permute(3, 0, 1, 2).contiguous()     # (4, y, x, t)
    got = conv_cuda.sepconv2(x_stack_l, box_taps[0], box_taps[1])
    ref3 = conv_cuda.sepconv2_plain(x_stack_l, box_taps[0], box_taps[1])
    torch.cuda.synchronize()
    diff = float((got - ref3).abs().max())
    check(diff == 0, 'sepconv path A multilook', diff)
    err['sepconv'] = max(err['sepconv'], diff)
    phase(9, 'sepconv (4,y,x,t) boxcar w=3 at %s: max abs diff %.3g'
          % (tuple(x_stack_l.shape), diff))
    # the yardsticks' reference outputs (the kernels, checked above)
    lib_calls = {
        'gauss': yardstick(c11v, (gauss_taps,) * 3,
                           conv_cuda.sepconv3(c11v, *(gauss_taps,) * 3)),
        'box3': yardstick(c11v, tuple(box3), conv_cuda.sepconv3(c11v, *box3)),
        'ml56': yardstick(x_stack_l, box_taps, got)}
    del got, ref3

    # ---- 10. path A: the long-stack chain, counted ---------------------------------
    ds_long = Dataset({v: (('y', 'x', 'time'), stack[..., i])
                       for i, v in enumerate(names)})
    nlm3 = ndt.NLMeansFilter(dims=('y', 'x', 'time'), r=(2, 2, 1), f=1,
                             sigma=2, h=3)
    omn3 = ndt.OmnibusTest(ml=3, alpha=0.99)
    reset_counts()
    flt3 = nlm3.apply(ds_long)
    change3 = omn3.apply(flt3)
    torch.cuda.synchronize()
    counts_a = read_counts()
    check(counts_a['nlmeans_3d'] > 0 and counts_a['omnibus_scan'] > 0
          and counts_a['omnibus_mixed'] > 0 and counts_a['sepconv'] > 0,
          'path A kernels', counts_a)
    stacked3 = torch.stack([flt3[v].data for v in names], -1)
    excess = float(((stacked3 - ref_nl3).abs()
                    - (1e-6 + 1e-5 * ref_nl3.abs())).max())
    check(excess <= 0, 'path A NLMeans', excess)
    del stacked3, ref_nl3

    def plain_look(fds):
        st = torch.stack([fds[v].data for v in names])       # (4, y, x, t)
        looked = conv_cuda.sepconv2_plain(st, box_taps[0], box_taps[1])
        return looked.permute(1, 2, 3, 0).contiguous()

    looked3 = plain_look(flt3)
    mixed3 = change_detection_plain(looked3, 0.99, n=9)
    mism = int((change3.data != mixed3).sum())
    check(change3.dims == ('y', 'x', 'time') and change3.data.device.type
          == 'cuda' and tuple(change3.data.shape) == (NY, NX, KL),
          'path A change map', change3.dims, change3.data.shape)
    check(mism == 0, 'path A mismatches', mism)
    check(float(mixed3.any(-1).float().mean()) > 0.99,
          'path A: the step is missed')
    _, suspects_a = change_detection_exact(looked3, 0.99, n=9,
                                           margin_eps=1e-4,
                                           return_count=True)

    def suspect_rows(vals):
        """The exact mode's gathered suspects of a long series."""
        _, margin = change_scan_cuda.change_detection_scan(
            vals, 0.99, n=9, return_packed=True)
        idx = torch.nonzero(~(margin > 1e-4).reshape(-1)).squeeze(1)
        return vals.reshape(-1, vals.shape[2], 4).index_select(0, idx)

    rows_a = suspect_rows(looked3)
    check(rows_a.shape[0] == suspects_a, 'path A suspects', suspects_a)
    planes_a = check_mixed('path A suspects k=%d N=%d, mixed'
                           % (KL, suspects_a), rows_a, 0.99, 9, 'mixed',
                           at=10)
    phase(10, 'path A (NLMeans 3-D -> OmnibusTest ml=3 alpha=0.99, k=%d): '
          'NLMeans within rtol 1e-5/atol 1e-6 of plain; %d mismatches vs '
          'plain f64 mixed scan; %d changes; %d suspects rescanned (%.3f%%); '
          'launches %s' % (KL, mism, int(mixed3.sum()), suspects_a,
                           100.0 * suspects_a / (NY * NX),
                           json.dumps(counts_a)))
    del flt3, change3, mixed3

    # ---- 11. path B: exact omnibus at k=200, counted -------------------------------
    reset_counts()
    exact_b, suspects_b = change_detection_exact(bcube, 0.99, n=9,
                                                 margin_eps=1e-4,
                                                 return_count=True)
    torch.cuda.synchronize()
    counts_b = read_counts()
    check(counts_b['omnibus_scan'] > 0 and counts_b['omnibus_mixed'] > 0
          and counts_b['omnibus'] == 0, 'path B kernels', counts_b)
    mixed_b = change_detection_plain(bcube, 0.99, n=9)
    mism = int((exact_b != mixed_b).sum())
    check(mism == 0, 'path B mismatches', mism)
    check(int(mixed_b[:, 0].sum()) > 2 * BNY, 'path B: no restart churn')
    phase(11, 'path B (exact omnibus k=%d on %dx%d): %d mismatches vs plain '
          'f64 mixed scan; %d changes (%d in the bursty column); %d '
          'suspects rescanned (%.2f%%); launches %s'
          % (BK, BNY, BNX, mism, int(mixed_b.sum()), int(mixed_b[:, 0].sum()),
             suspects_b, 100.0 * suspects_b / (BNY * BNX),
             json.dumps(counts_b)))
    del exact_b, mixed_b
    rows_b = suspect_rows(bcube)
    check(rows_b.shape[0] == suspects_b, 'path B suspects', suspects_b)
    planes_b = check_mixed('path B suspects k=%d N=%d, mixed'
                           % (BK, suspects_b), rows_b, 0.99, 9, 'mixed',
                           at=11)

    # ---- 12. path C: three-axis filters of one variable, counted -------------------
    c11_da = ds_long['C11']
    gauss_f = ndt.GaussianFilter(dims=('y', 'x', 'time'), sigma=1)
    box_f = ndt.BoxcarFilter(dims=('y', 'x', 'time'), w=3)
    reset_counts()
    smooth = gauss_f.apply(c11_da)
    boxed = box_f.apply(c11_da)
    torch.cuda.synchronize()
    counts_c = read_counts()
    check(counts_c['sepconv3'] >= 2, 'path C kernels', counts_c)
    for label, out, taps in (('GaussianFilter', smooth, (gauss_taps,) * 3),
                             ('BoxcarFilter', boxed, tuple(box3))):
        ref3 = conv_cuda.sepconv3_plain(c11v, *taps).reshape(NY, NX, KL)
        diff = float((out.data - ref3).abs().max())
        check(out.dims == ('y', 'x', 'time') and diff == 0,
              'path C', label, out.dims, diff)
        phase(12, 'path C %s(dims=(y,x,time)): max abs diff %.3g vs the '
              'plain three-axis pass' % (label, diff))
    phase(12, 'path C launches %s' % json.dumps(counts_c))
    del smooth, boxed, ref3

    # ---- 13. long-stack times -----------------------------------------------------
    mpix_l = NY * NX * KL / 1e6
    mpix_b = BNY * BNX * BK / 1e6
    cap56 = change_cuda._round_cap(KL)
    tabs56 = change_scan_cuda.scan_tables(KL, 9, 0.99)
    tabs200 = change_scan_cuda.scan_tables(BK, 9, 0.99)

    def plain_chain_a():
        fds = expand_stack(nlmeans_cuda.nlmeans_3d_plain(stack, r3, f3, 2.0,
                                                         3.0))
        return change_detection_plain(plain_look(fds), 0.99, n=9)

    def plain_c():
        conv_cuda.sepconv3_plain(c11v, *(gauss_taps,) * 3)
        conv_cuda.sepconv3_plain(c11v, *box3)

    # the exact mode's rescan from the scan kernel's margins (suspects
    # selected on the card), on paths A's and B's series
    rescans = {}
    for key, vals in (('A', looked3), ('B', bcube)):
        pk, mg = change_scan_cuda.change_detection_scan(vals, 0.99, n=9,
                                                        return_packed=True)
        rescans[key] = (vals.reshape(-1, vals.shape[2], 4), mg, pk,
                        pk.clone())

    long_timed = [
        # label, key, Mpix, kernel, plain, bound, yardstick, plain once
        ('sepconv3 gaussian (y,x,t)', 'sepconv3', mpix_l,
         lambda: conv_cuda.sepconv3(c11v, *(gauss_taps,) * 3),
         lambda: conv_cuda.sepconv3_plain(c11v, *(gauss_taps,) * 3),
         sepconv_bound(c11v, *(gauss_taps,) * 3), lib_calls['gauss'], False),
        ('sepconv3 boxcar (y,x,t)', None, mpix_l,
         lambda: conv_cuda.sepconv3(c11v, *box3),
         lambda: conv_cuda.sepconv3_plain(c11v, *box3),
         sepconv_bound(c11v, *box3), lib_calls['box3'], False),
        ('sepconv (4,y,x,t) k=56', None, mpix_l,
         lambda: conv_cuda.sepconv2(x_stack_l, *box_taps),
         lambda: conv_cuda.sepconv2_plain(x_stack_l, *box_taps),
         sepconv_bound(x_stack_l, *box_taps), lib_calls['ml56'], False),
        ('nlmeans_3d r=(2,2,1) f=1', 'nlmeans_3d', mpix_l,
         lambda: nlmeans_cuda.nlmeans_3d(stack, r3, f3, 2.0, 3.0),
         lambda: nlmeans_cuda.nlmeans_3d_plain(stack, r3, f3, 2.0, 3.0),
         nlmeans_bound(stack, r3, f3), None, True),
        ('omnibus_scan k=56', 'omnibus_scan', mpix_l,
         lambda: change_scan_cuda.change_detection_scan(
             stack, 0.99, n=9, return_packed=True),
         lambda: change_scan_cuda.scan_plain(stack, tabs56, 9.0),
         scan_bound(stack, tabs56), None, True),
        ('omnibus round k=56 capped', None, mpix_l,
         lambda: change_cuda.change_detection_fast(
             stack, 0.99, n=9, return_margin=True, return_packed=True,
             max_rounds=cap56), None,
         round_bound(stack, change_cuda.change_detection_fast(
             stack, 0.99, n=9, return_margin=True, return_packed=True,
             max_rounds=cap56)[0], cap56), None, False),
        ('omnibus_scan k=200', 'omnibus_scan_200', mpix_b,
         lambda: change_scan_cuda.change_detection_scan(
             bcube, 0.99, n=9, return_packed=True),
         lambda: change_scan_cuda.scan_plain(bcube, tabs200, 9.0),
         scan_bound(bcube, tabs200), None, True),
        ('omnibus_mixed path A suspects', None, rows_a.shape[0] * KL / 1e6,
         lambda: change_mixed_cuda.mixed_scan(rows_a, 0.99, 9, 'mixed'),
         lambda: change_mixed_cuda.mixed_scan_plain(rows_a, 0.99, 9,
                                                    'mixed'),
         mixed_bound(rows_a, planes_a), None, True),
        ('omnibus_mixed path B suspects', 'omnibus_mixed',
         rows_b.shape[0] * BK / 1e6,
         lambda: change_mixed_cuda.mixed_scan(rows_b, 0.99, 9, 'mixed'),
         lambda: change_mixed_cuda.mixed_scan_plain(rows_b, 0.99, 9,
                                                    'mixed'),
         mixed_bound(rows_b, planes_b), None, True),
        ('rescan path A from margins', None, rows_a.shape[0] * KL / 1e6,
         lambda: change_mixed_cuda.rescan(*rescans['A'][:3], 0.99, 9, 1e-4),
         lambda: change_mixed_cuda.rescan_plain(
             *rescans['A'][:2], rescans['A'][3], 0.99, 9, 1e-4),
         mixed_bound(rows_a, planes_a, NY * NX), None, True),
        ('rescan path B from margins', None, rows_b.shape[0] * BK / 1e6,
         lambda: change_mixed_cuda.rescan(*rescans['B'][:3], 0.99, 9, 1e-4),
         lambda: change_mixed_cuda.rescan_plain(
             *rescans['B'][:2], rescans['B'][3], 0.99, 9, 1e-4),
         mixed_bound(rows_b, planes_b, BNY * BNX), None, True),
        ('path A exact k=56', None, mpix_l,
         lambda: change_detection_exact(looked3, 0.99, n=9, margin_eps=1e-4),
         lambda: change_detection_plain(looked3, 0.99, n=9), None, None,
         True),
        ('path A long-stack chain', None, mpix_l,
         lambda: omn3.apply(nlm3.apply(ds_long)), plain_chain_a, None, None,
         True),
        ('path B exact k=200', None, mpix_b,
         lambda: change_detection_exact(bcube, 0.99, n=9, margin_eps=1e-4),
         lambda: change_detection_plain(bcube, 0.99, n=9), None, None,
         True),
        ('path C Gaussian + boxcar', None, mpix_l,
         lambda: (gauss_f.apply(c11_da), box_f.apply(c11_da)), plain_c,
         None, None, False),
    ]
    time_rows(13, long_timed)
    for key, vals in (('omnibus_scan', stack), ('omnibus_scan_200', bcube)):
        ny, nx, k, _ = vals.shape
        moved = vals.numel() * 4 + ny * nx * 4 * ((k + 30) // 31 + 1)
        phase(13, 'omnibus_scan k=%d: %.3f ms, %.1f GB/s (the series read '
              'once, planes and margins written once; data sheet %.0f GB/s)'
              ' | %s' % (k, row_ms[key]['ms'], moved / row_ms[key]['ms'] / 1e6,
                         HBM_BYTES_PER_S / 1e9, card))
    del lib_calls, rows_a, rows_b, rescans
    phase(13, 'peak device memory %.2f GiB | %s'
          % (torch.cuda.max_memory_allocated() / 2 ** 30, card))

    # ---- 14. the streaming probe, counted ------------------------------------------
    flat = cube.reshape(-1, stream_cuda.COLS)              # (49152, 1024)
    nbytes = flat.numel() * flat.element_size()
    reset_counts()
    got = stream_cuda.stream_plus_one(flat)
    torch.cuda.synchronize()
    counts_p = read_counts()
    check(counts_p['stream_probe'] == 1, 'probe kernel', counts_p)
    diff = float((got - stream_cuda.stream_plus_one_plain(flat)).abs().max())
    check(diff == 0, 'stream probe', diff)
    err['stream_probe'] = diff
    del got
    phase(14, 'stream probe on %s float32 (%.0f MB): max abs diff %.3g; '
          'launches %s' % (tuple(flat.shape), nbytes / 1e6, diff,
                           json.dumps(counts_p)))
    time_rows(14, [
        ('stream probe x + 1', 'stream_probe', flat.numel() / 1e6,
         lambda: stream_cuda.stream_plus_one(flat),
         lambda: stream_cuda.stream_plus_one_plain(flat),
         bound(2 * nbytes, flat.numel()), lambda: torch.add(flat, 1),
         False)])
    row = row_ms['stream_probe']
    phase(14, 'stream probe: kernel %.1f GB/s, plain x + 1 %.1f GB/s, '
          'torch.add(x, 1) %.1f GB/s (2 x bytes / time); data sheet %.0f '
          'GB/s | %s' % (2 * nbytes / row['ms'] / 1e6,
                         2 * nbytes / row['plain_ms'] / 1e6,
                         2 * nbytes / row['library_ms'] / 1e6,
                         HBM_BYTES_PER_S / 1e9, card))

    def run_ms(fn, n=50, reps=5):
        """ms per call of n back-to-back calls between one event pair
        (median of reps runs after one warm-up run): the host work of a
        call hides behind the previous call's device time."""
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / n)
        return statistics.median(times)

    probe_runs, add_runs = [], []
    for runs, fn in ((probe_runs, lambda: stream_cuda.stream_plus_one(flat)),
                     (add_runs, lambda: torch.add(flat, 1)),
                     (add_runs, lambda: torch.add(flat, 1)),
                     (probe_runs, lambda: stream_cuda.stream_plus_one(flat))):
        runs.append(run_ms(fn))
    run_k, run_add = min(probe_runs), min(add_runs)
    phase(14, 'stream probe, 50 back-to-back calls per event pair: kernel '
          '%.4f ms (%.1f GB/s), torch.add(x, 1) %.4f ms (%.1f GB/s), x%.3f; '
          'single calls: kernel %.4f ms, torch.add %.4f ms | %s'
          % (run_k, 2 * nbytes / run_k / 1e6, run_add,
             2 * nbytes / run_add / 1e6, run_add / run_k, row['ms'],
             row['library_ms'], card))

    # ---- 15-16. the long-tap and wide-window kernels, counted
    counts_long, counts_mixed, counts_wide = run_wide_phases(
        ndt, card, cuda_ms, once_ms, time_rows, reset_counts, read_counts,
        c11_da, stack, names, err)

    # ---- W1-W5. the georeferencing path, its chain counted ------------------
    counts_w5 = run_warp_phases(ndt, dev, card, cuda_ms, reset_counts,
                                read_counts, box_taps)


    # ---- 17. the exact calls' host share --------------------------------------------
    for label, vals in (('phase 4 exact (k=%d)' % K, cube),
                        ('path A exact (k=%d)' % KL, looked3),
                        ('path B exact (k=%d)' % BK, bcube)):
        def call():
            return change_detection_exact(vals, 0.99, n=9, margin_eps=1e-4)
        event_ms = cuda_ms(call)
        wall, busy, events, top = profiled(call)
        phase(17, '%s: under torch.profiler wall %.3f ms, device busy %.3f '
              'ms (%.1f%%), %d device events; that device time over the '
              'call\'s CUDA-event time (%.3f ms, median of 7, no profiler): '
              '%.1f%%; top %s | %s'
              % (label, wall, busy, 100.0 * busy / wall, events, event_ms,
                 100.0 * busy / event_ms,
                 ', '.join('%s %.3f ms' % kv for kv in top), card))

    # ---- T1-T3. the training path, T1 counted (after phase 17: their
    # profiler windows left later windows without some kernels' events)
    counts_t1 = run_training_phases(ndt, dev, card, cuda_ms, reset_counts,
                                    read_counts, cube, t_labels)

    # ---- S1-S5. the dated stack: stencil, njobs, the time-series chain,
    # grouped reductions, apply
    counts_s = run_series_phases(ndt, dev, card, cuda_ms, reset_counts,
                                 read_counts, cube, stack, box_taps, row_ms,
                                 err)

    # ---- I1-I4. the I/O layer: the quick start from a file, counted;
    # O1-O4. lazy opens and tiling of I1's and I3's files, counted
    import tempfile
    with tempfile.TemporaryDirectory() as io_tmp:
        counts_i2 = run_io_phases(ndt, dev, card, cuda_ms, reset_counts,
                                  read_counts, cube, readme_change, io_tmp)
        counts_o = run_out_of_core_phases(ndt, dev, card, reset_counts,
                                          read_counts, readme_filtered,
                                          readme_change, io_tmp)
        # ---- P1-P5. the device mesh: the quick start, path A's NLMeans and
        # the training step sharded, two processes on the card; counted
        counts_mesh = run_sharded_phases(ndt, dev, card, cuda_ms,
                                         reset_counts, read_counts, cube,
                                         stack, t_labels, readme_change,
                                         io_tmp)

    # ---- J1-J4. a Sentinel-2 granule classified on rasterized parcels
    counts_j = run_granule_phases(ndt, dev, card, cuda_ms, reset_counts,
                                  read_counts, root)

    # ---- V1-V4. the README chain traced, the host oracles, rendering,
    # change_detection_hybrid and TorchClassifier.train_step; V1 and V4
    # counted
    counts_v = run_visual_phases(ndt, dev, card, cuda_ms, reset_counts,
                                 read_counts, cube, exact, readme_change,
                                 readme_filtered, root)

    # ---- E1-E5. the repaired faults on the card; the four workflows of
    # examples_torch/ at their default and real sizes, counted
    run_fault_phases(dev, card, cube)
    counts_e = run_example_phases(dev, card, reset_counts, read_counts, root)

    totals = {name: sum(c[name] for c in (launches, counts_a, counts_b,
                                          counts_c, counts_p, counts_long,
                                          counts_mixed, counts_wide,
                                          counts_w5, counts_t1,
                                          counts_i2, counts_j) + counts_s
                                         + counts_o + counts_mesh + counts_v
                                         + tuple(counts_e))
              for name in KERNELS}
    phase(17, 'chip_smoke ran %.1f s, the build included'
          % (time.perf_counter() - started))
    kernels = [dict({'name': name, 'route': 'cuda', 'source': src,
                     'replaces': tpu, 'launches': totals[name],
                     'max_abs_err': err[name]}, **row_ms[name])
               for name, (src, tpu, _, _) in KERNELS.items()]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
