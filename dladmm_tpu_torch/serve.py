"""Serving path: bucketed D-LADMM inference on a trained solver.

The port of ``dladmm_tpu/serve.py`` (single-device servers and CLI):

  * Batch bucketing: requests are padded up to the next power-of-two
    bucket and the padded rows discarded; every row is independent, so
    padding is exact.
  * Warm buckets: the JAX server compiles every bucket ahead of time.
    Here construction runs each bucket once on the device instead, so
    the kernel's build and first launch never land on a request.
  * Route: models/api.inference_forward, asked once for every bucket:
    the whole-unroll CUDA kernel for l1/l1 and for trained elementwise
    proxes; the plain loop for general B, group_l2 and
    ``kernel="reference"``.
  * ``dtype="int8"`` (l1/l1, identity B): the net and its dictionary are
    quantized once at construction (ops/quantized.quantize_params) and
    every bucket runs the int8 whole-unroll CUDA kernel
    (ops/cuda_int8.int8_unroll_forward) for ``auto`` and ``megakernel``,
    or the plain int8 scan (ops/quantized.dladmm_forward_int8) for
    ``reference``. The JAX package took its scan for ``auto``; the port
    takes the kernel, which has no fit gate (models/api.py). The quality
    contract is the JAX package's: NMSE within 0.3 dB of fp32 serving.
  * ``dtype=torch.bfloat16`` (or ``"bfloat16"``): params, A and B are
    cast to bf16 once at construction and each request per call, as the
    JAX package does; the whole-unroll kernel's bf16-storage variant
    (fp32 arithmetic, each layer's stored state rounded to bf16,
    ops/cuda_unroll.unroll_forward_plain_bf16) serves l1/l1 and the
    trained elementwise proxes, the plain loop in bf16 general B,
    group_l2 and ``kernel="reference"``. x and z come back in bf16.

Runs on CUDA unless the caller asks for the CPU (``device="cpu"`` or
``DLADMM_PLATFORM=cpu``; utils/platform.py).

The CLI serves a training checkpoint (``--ckpt-dir``: the newest
step_N's params and the dictionary they were trained on) or a
reference-style PyTorch file (``--import-torch``, on the config's
dictionary). ``ShardedInferenceServer`` (``--sharded``) splits request
rows over the data parts of a mesh (parallel/mesh.py), each part served
by the single-device stack above, with no collective. A later slice
(ROADMAP.md): one CUDA Graph per bucket.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from dladmm_tpu_torch.models.api import inference_forward
from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.ops.quantized import quantize_params
from dladmm_tpu_torch.utils import profiling
from dladmm_tpu_torch.utils.platform import resolve_device

# The serving CLI's --kernel choices, the JAX package's (its per-layer
# "pallas" kernel is no serving choice).
CLI_KERNELS = ("auto", "megakernel", "reference")


def _buckets(max_batch: int) -> Tuple[int, ...]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def _bucket_of(buckets, S: int) -> int:
    """The smallest bucket that holds S rows."""
    for b in buckets:
        if S <= b:
            return b
    raise ValueError(f"batch {S} exceeds max bucket {buckets[-1]}")


def _pad_request(server, b, device=None) -> Tuple[Tensor, int]:
    """A request b (S, m), a tensor or an array, for ``server``'s buckets:
    (b cast to its ``request_dtype`` (through float32, as the JAX
    package's requests are) on ``device`` (None: where b is), padded with
    zero rows to the bucket, S)."""
    b = torch.as_tensor(b)
    if b.ndim != 2 or b.shape[1] != server.m:
        raise ValueError(f"expected (S, {server.m}), got {tuple(b.shape)}")
    S = b.shape[0]
    bucket = _bucket_of(server.buckets, S)
    if b.dtype != server.request_dtype:
        b = b.to(torch.float32)
    b = b.to(device, server.request_dtype)
    if bucket != S:
        b = torch.cat([b, b.new_zeros((bucket - S, server.m))])
    return b.contiguous(), S


def _prep_serving(params, A, B, dtype, layers, device):
    """Shared serving preamble: early-exit layer slice, then every
    tensor as a contiguous tensor of the serving type on ``device``:
    bfloat16 for ``dtype`` torch.bfloat16 or "bfloat16", float32 for
    None, "float32" or torch.float32 and for "int8". Returns (params, A,
    B, quantized): with dtype="int8" quantization is left to the server
    (ops/quantized.quantize_params) and ``quantized`` is True."""
    quantized = dtype == "int8"
    if dtype in (torch.bfloat16, "bfloat16"):
        storage = torch.bfloat16
    elif quantized or dtype in (None, "float32", torch.float32):
        storage = torch.float32
    else:
        raise ValueError(f"serving dtype={dtype!r}; the port serves float32, bfloat16 and int8")
    if layers is not None:
        K = params.W1.shape[0]
        if not 1 <= layers <= K:
            raise ValueError(f"layers must be in [1, {K}], got {layers}")
        params = DLADMMParams(*(v[:layers] for v in params))

    def put(t):
        return torch.as_tensor(t).detach().to(device, storage).contiguous()

    params = DLADMMParams(*(put(v) for v in params))
    return params, put(A), None if B is None else put(B), quantized


class InferenceServer:
    """D-LADMM inference over batch buckets, warmed at construction.

    >>> server = InferenceServer(params, A, max_batch=256)
    >>> x, z = server.solve(b)     # b: (S, m), any S <= max_batch
    """

    def __init__(
        self,
        params: DLADMMParams,
        A: Tensor,
        max_batch: int = 256,
        kernel: str = "auto",
        buckets: Optional[Sequence[int]] = None,
        dtype=None,
        layers: Optional[int] = None,
        B: Optional[Tensor] = None,
        step_fn=None,
        prox_pair=None,
        device=None,
    ):
        """layers=k serves only the first k of the trained K layers (an
        early-exit latency/quality knob; layer parameters are untied, so
        the k-layer net is the trained net's prefix).

        B: general z-dictionary (m, d), served by the plain loop (the
        kernel assumes B = I); returns (x, z) with z in R^d.

        step_fn: a general-prox cached layer step
        (ops/reference.make_cached_step), served by the plain loop.
        prox_pair: the (prox_x, prox_z) callables themselves: buckets
        serve through the prox-templated kernel when it has both
        proxes' variants (ops/cuda_unroll.prox_megakernel_available),
        else through the plain loop. Identity B only.

        dtype="int8" serves int8-quantized weights with dynamic per-sample
        activation quantization (module docstring): l1/l1 and identity B
        only; kernel="auto"/"megakernel" take the int8 kernel,
        "reference" the plain int8 scan.

        dtype=torch.bfloat16 (or "bfloat16") serves in bf16: params, A
        and B are cast once here, requests on each call (``request_dtype``),
        and x, z come back in bf16 (module docstring).

        device: ``cuda`` unless asked otherwise (utils/platform.py)."""
        self.device = resolve_device(device)
        params, A, B, quantized = _prep_serving(params, A, B, dtype, layers, self.device)
        m = A.shape[0]
        # One route for every bucket: no rung reads the batch size.
        self._forward, route, _ = inference_forward(
            m, params.W2.shape[1], kernel, "int8" if quantized else A.dtype, B=B, prox_pair=prox_pair,
            step_fn=step_fn, device=self.device,
        )
        self.params = params
        self.A = A
        self.B = B
        self.m = m
        # The type requests are cast to: the served type, but float32 for
        # int8 (the kernel quantizes the activations itself).
        self.request_dtype = A.dtype
        self.buckets = tuple(sorted(buckets or _buckets(max_batch)))
        self.routes = dict.fromkeys(self.buckets, route)
        # What the forward takes before the requests: the net and
        # dictionary quantized ONCE here (requests pay only the
        # activations'), or the params and A.
        self._operands = quantize_params(params, A) if quantized else (params, A)
        # Run every bucket once now: the kernel's build and first launch
        # happen here, never on a request.
        for S in self.buckets:
            self._run(torch.zeros((S, m), dtype=self.request_dtype, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _bucket_for(self, S: int) -> int:
        return _bucket_of(self.buckets, S)

    def _run(self, b: Tensor):
        with torch.no_grad():
            return self._forward(*self._operands, b)[:2]

    def solve(self, b) -> Tuple[Tensor, Tensor]:
        """b (S, m), a tensor or an array -> (x (S, n), z (S, d)) on the
        server's device, in the served type (bf16 for a bf16 server);
        the request is cast to ``request_dtype`` (through float32, as the
        JAX package's requests are), padded to the bucket size and sliced
        back. Rows are independent, so results are exact. Traced as
        ``serve.solve``, holding ``serve.prep`` (the request on the
        device, padded) and then ``serve.forward`` (the forward's
        enqueue)."""
        with profiling.span("serve.solve"):
            with profiling.span("serve.prep"):
                b, S = _pad_request(self, b, self.device)
            with profiling.span("serve.forward"):
                x, z = self._run(b)
            return x[:S], z[:S]


class ShardedInferenceServer:
    """Data-parallel serving over the data parts of a one-process mesh.

    The parameters and the dictionary go to every part's device; request
    rows are split over the parts (``mesh.shape["data"]`` of them, each
    on ``mesh.devices[j]``), each part runs the single-device serving
    stack (an InferenceServer: the whole-unroll kernel in fp32 or bf16,
    the int8 kernel, the plain loop for general B and group_l2) on its
    rows, and the parts' results are gathered on the first part's
    device. Rows are independent, so there is no collective and the
    result equals the single-device server's row for row. Parts on one
    device share its server.

    Buckets are multiples of the part count T (each part serves
    bucket / T rows); the defaults are the single-device power-of-two
    ladder times T.

    >>> server = ShardedInferenceServer(params, A, make_mesh(), max_batch=4096)
    >>> x, z = server.solve(b)                 # b: (S, m), S <= 4096
    """

    def __init__(
        self,
        params: DLADMMParams,
        A: Tensor,
        mesh=None,
        max_batch: int = 4096,
        kernel: str = "auto",
        buckets: Optional[Sequence[int]] = None,
        dtype=None,
        layers: Optional[int] = None,
        B: Optional[Tensor] = None,
        step_fn=None,
        prox_pair=None,
        device=None,
    ):
        """mesh: a one-process mesh (parallel/mesh.make_mesh; default:
        every visible card, or the CPU where ``device`` or DLADMM_PLATFORM
        asks for it). The other arguments are InferenceServer's."""
        from dladmm_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh

        if mesh is None:
            mesh = make_mesh(device=device)
        if mesh.shape[MODEL_AXIS] != 1:
            raise ValueError(
                "serving is data-parallel only: rows are independent, so use a "
                f"model=1 mesh (got {mesh.shape})"
            )
        T = mesh.shape[DATA_AXIS]
        if len(mesh.devices) != T:
            raise ValueError(
                f"serving splits rows over this process's {T} data parts; the mesh holds "
                f"{len(mesh.devices)} device(s) here (a distributed run's mesh holds one a rank)"
            )
        self.mesh = mesh
        self.T = T
        if buckets is None:
            # Round max_batch up to a multiple of T: solve pads rows exactly.
            max_batch = -(-max_batch // T) * T
            buckets = tuple(b * T for b in _buckets(max_batch // T))
        self.buckets = tuple(sorted(buckets))
        for S in self.buckets:
            if S % T:
                raise ValueError(f"bucket {S} not divisible by data axis size {T}")
        self._servers = {}
        for dev in dict.fromkeys(mesh.devices):
            self._servers[dev] = InferenceServer(
                params, A, kernel=kernel, buckets=tuple(S // T for S in self.buckets), dtype=dtype,
                layers=layers, B=B, step_fn=step_fn, prox_pair=prox_pair, device=dev,
            )
        first = self._servers[mesh.devices[0]]
        self.device = first.device
        self.m = first.m
        self.request_dtype = first.request_dtype
        self.routes = {S: first.routes[S // T] for S in self.buckets}

    def solve(self, b) -> Tuple[Tensor, Tensor]:
        """b (S, m) -> (x (S, n), z (S, d)) on the first part's device:
        the rows padded to the bucket, split into T parts of bucket / T
        rows, each solved on its part's device, gathered and sliced back."""
        b, S = _pad_request(self, b)
        parts = [self._servers[dev].solve(chunk) for dev, chunk in zip(self.mesh.devices, b.chunk(self.T))]
        x = torch.cat([xp.to(self.device) for xp, _ in parts])
        z = torch.cat([zp.to(self.device) for _, zp in parts])
        return x[:S], z[:S]


class BatchingServer:
    """Host-side micro-batching front end over an InferenceServer.

    Queues rows from concurrent clients and dispatches them to the
    buckets as ONE device call per window. Rows are independent, so
    batching requests together is exact (held against per-request
    solves by tests/test_torch_serve.py).

    Policy: a dispatch fires as soon as (a) the queued rows fill the
    largest bucket, or (b) ``max_delay_ms`` has elapsed since the
    oldest queued request. One worker thread owns the device dispatch;
    the kernel wrapper takes the device from the tensors and launches
    on that thread's current stream.

    >>> bs = BatchingServer(InferenceServer(params, A, max_batch=256))
    >>> fut = bs.submit(b_rows)          # (s, m), any small s
    >>> x, z = fut.result()              # numpy (s, n), (s, d)
    >>> bs.close()

    Over a bf16 server the futures resolve to float32 arrays holding the
    bf16 results exactly (numpy has no bf16; the JAX package's server
    returns ml_dtypes bf16 arrays).
    """

    def __init__(self, server: InferenceServer, max_delay_ms: float = 2.0):
        import queue
        import threading

        self.server = server
        self.max_delay = max_delay_ms / 1e3
        self.max_rows = server.buckets[-1]
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        # Serializes the closed-check-then-enqueue in submit() against
        # close()'s set-closed-then-sentinel, so no request can land
        # behind the None sentinel and strand its future.
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, b):
        """Enqueue a (s, m) request (s <= the largest bucket), cast to the
        server's ``request_dtype``; returns a concurrent.futures.Future
        resolving to numpy float32 (x (s, n), z (s, d))."""
        from concurrent.futures import Future

        if self._closed:
            raise RuntimeError("BatchingServer is closed")
        b = torch.as_tensor(np.asarray(b, dtype=np.float32)).to(self.server.request_dtype)
        if b.ndim != 2 or b.shape[1] != self.server.m:
            raise ValueError(f"expected (s, {self.server.m}), got {tuple(b.shape)}")
        if b.shape[0] > self.max_rows:
            raise ValueError(
                f"request rows {b.shape[0]} exceed the largest bucket "
                f"{self.max_rows}; split the request"
            )
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("BatchingServer is closed")
            self._q.put((b, fut))
        return fut

    def solve(self, b):
        """Blocking convenience wrapper around submit()."""
        return self.submit(b).result()

    def close(self):
        """Drain the queue, stop the worker. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # wake the worker (FIFO: after all requests)
        self._worker.join()

    # -- worker ---------------------------------------------------------

    def _run(self):
        import queue as _queue
        import time as _time

        while True:
            item = self._q.get()
            if item is None:
                return
            window = [item]
            rows = item[0].shape[0]
            deadline = _time.monotonic() + self.max_delay
            # Fill the window until the largest bucket or the oldest
            # request's latency budget runs out.
            while rows < self.max_rows:
                timeout = deadline - _time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except _queue.Empty:
                    break
                if nxt is None:
                    self._dispatch(window)
                    return
                if rows + nxt[0].shape[0] > self.max_rows:
                    # Doesn't fit this window: dispatch, start the next
                    # window with it (requests stay whole).
                    self._dispatch(window)
                    window = [nxt]
                    rows = nxt[0].shape[0]
                    deadline = _time.monotonic() + self.max_delay
                    continue
                window.append(nxt)
                rows += nxt[0].shape[0]
            self._dispatch(window)

    def _dispatch(self, window):
        # Claim each future first: a client may have cancelled while its
        # request was queued, and set_result on a cancelled future
        # raises (which would kill the worker).
        window = [
            (b, fut)
            for b, fut in window
            if fut.set_running_or_notify_cancel()
        ]
        if not window:
            return
        bs = torch.cat([b for b, _ in window])
        try:
            x, z = self.server.solve(bs)
            x, z = x.float().cpu().numpy(), z.float().cpu().numpy()
        except Exception as e:  # surface device errors on the futures
            for _, fut in window:
                fut.set_exception(e)
            return
        off = 0
        for b, fut in window:
            s = b.shape[0]
            fut.set_result((x[off : off + s], z[off : off + s]))
            off += s


def _read_requests(spec: str) -> np.ndarray:
    """Load request rows from ``file.npy`` or ``file.npz[:key]``."""
    from dladmm_tpu_torch.data.synthetic import load_array_spec

    arr = np.asarray(load_array_spec(spec), np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2:
        raise ValueError(f"requests must be (S, m); got shape {arr.shape}")
    return arr


def main(argv=None) -> int:
    """CLI: serve a trained solver over a file of requests (or a
    synthetic demo batch) through the bucketed server. Runs on CUDA
    unless DLADMM_PLATFORM=cpu."""
    import argparse
    import json
    import time

    from dladmm_tpu_torch.data.synthetic import problem_matrices
    from dladmm_tpu_torch.ops.prox import resolve_prox
    from dladmm_tpu_torch.utils.config import get_config
    from dladmm_tpu_torch.utils.torch_compat import from_torch

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--config", default="synthetic_small")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument(
        "--ckpt-dir",
        help="training checkpoint dir: serve the newest step_N's params "
        "on the dictionary stored with them",
    )
    src.add_argument(
        "--import-torch",
        metavar="CKPT",
        help="serve weights from a reference-style PyTorch checkpoint",
    )
    ap.add_argument(
        "--allow-pickle",
        action="store_true",
        help="permit --import-torch to fully unpickle torch.save(net) "
        "whole-module checkpoints (trusted files only)",
    )
    req = ap.add_mutually_exclusive_group(required=True)
    req.add_argument(
        "--input",
        default=None,
        metavar="FILE[:key]",
        help="request rows (S, m) from .npy or .npz; default key 'b'",
    )
    req.add_argument(
        "--demo",
        type=int,
        default=None,
        metavar="S",
        help="serve S synthetic requests from the config's eval "
        "distribution instead of --input, and report NMSE vs the "
        "ground truth",
    )
    ap.add_argument("--out", default=None, help="write x, z to this .npz")
    ap.add_argument(
        "--dtype",
        choices=["float32", "bfloat16", "int8"],
        default="float32",
        help="serving precision: float32; bfloat16 (params, A and requests "
        "cast once, x and z in bf16); or int8 (l1/l1, identity B; NMSE "
        "within 0.3 dB of float32)",
    )
    ap.add_argument("--kernel", choices=list(CLI_KERNELS), default="auto")
    ap.add_argument(
        "--layers",
        type=int,
        default=None,
        help="early exit: serve only the first k trained layers",
    )
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument(
        "--sharded",
        action="store_true",
        help="data-parallel serving over every visible card "
        "(ShardedInferenceServer)",
    )
    args = ap.parse_args(argv)
    latest = None
    if args.ckpt_dir:
        from dladmm_tpu_torch.utils.checkpoint import latest_step_dir

        latest = latest_step_dir(args.ckpt_dir)
        if latest is None:
            ap.error(
                f"no step_N checkpoint under {args.ckpt_dir!r}; train one with "
                f"python -m dladmm_tpu_torch.run --config=... --ckpt-dir={args.ckpt_dir}"
            )
    device = resolve_device()
    cfg = get_config(args.config)
    # General-prox configs: the served forward must run the SAME prox
    # pair the model was trained with.
    prox = resolve_prox(cfg.problem)
    if prox is not None and args.dtype == "int8":
        ap.error(
            f"--dtype=int8 is l1/l1-only; config {args.config!r} trains prox "
            f"{cfg.problem.prox_x}/{cfg.problem.prox_z}"
        )
    step_fn = None if prox is None else make_cached_step(*prox)
    if latest is not None:
        from dladmm_tpu_torch.utils.checkpoint import load_params

        params, A, B = load_params(latest, device)
        if A is None or tuple(A.shape) != (cfg.problem.m, cfg.problem.n):
            ap.error(f"{latest} holds no dictionary of config {args.config!r}'s shape")
    else:
        A, B = problem_matrices(cfg, device=device)
        params = from_torch(
            args.import_torch, A=A, allow_pickle=args.allow_pickle, device=device
        )

    demo = None
    if args.demo is not None:
        from dladmm_tpu_torch.data.synthetic import make_batch, seed_keys

        p = cfg.problem
        demo = make_batch(
            seed_keys(cfg)[1],
            A,
            args.demo,
            p.sparsity_x,
            p.sparsity_e,
            B=B,
            nonneg_x=getattr(p, "nonneg_x", False),
        )
        requests = demo.b
    else:
        requests = torch.from_numpy(_read_requests(args.input))

    max_batch = args.max_batch or max(1, requests.shape[0])
    # One-shot CLI: a single bucket covering the whole request set; a
    # sharded bucket is a multiple of the data parts.
    kw = {"device": device}
    if args.sharded:
        from dladmm_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device=device)
        max_batch = -(-max_batch // mesh.shape["data"]) * mesh.shape["data"]
        kw = {"mesh": mesh}
    t_build = time.monotonic()
    server = (ShardedInferenceServer if args.sharded else InferenceServer)(
        params,
        A,
        max_batch=max_batch,
        kernel=args.kernel,
        buckets=(max_batch,),
        dtype=None if args.dtype == "float32" else args.dtype,
        layers=args.layers,
        B=B,
        step_fn=step_fn,
        prox_pair=prox if (prox is not None and B is None) else None,
        **kw,
    )
    build_s = time.monotonic() - t_build

    t_solve = time.monotonic()
    x, z = server.solve(requests)
    x, z = x.cpu(), z.cpu()  # waits for the device
    solve_s = time.monotonic() - t_solve

    x, z = x.float(), z.float()  # bf16 values, exactly (numpy has no bf16)
    if args.out:
        np.savez(args.out, x=x.numpy(), z=z.numpy())
    summary = {
        "requests": int(requests.shape[0]),
        "config": args.config,
        "dtype": args.dtype,
        "kernel": args.kernel,
        "route": server.routes[max_batch],
        "device": str(device),
        "layers": args.layers,
        "sharded": bool(args.sharded),
        "data_parts": server.T if args.sharded else 1,
        "buckets": list(server.buckets),
        "warm_build_s": build_s,
        # Host wall time of one solve, including the copy back.
        "solve_wall_s": solve_s,
        "out": args.out,
    }
    if demo is not None:
        from dladmm_tpu_torch.metrics.core import nmse_db

        summary["nmse_db"] = float(nmse_db(x, demo.x_star.cpu()))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
