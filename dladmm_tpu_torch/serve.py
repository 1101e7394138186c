"""Serving path: bucketed D-LADMM inference on a trained solver.

The port of ``dladmm_tpu/serve.py`` (single-device servers and CLI):

  * Batch bucketing: requests are padded up to the next power-of-two
    bucket and the padded rows discarded; every row is independent, so
    padding is exact.
  * Warm buckets: the JAX server compiles every bucket ahead of time.
    Here construction runs each bucket once on the device instead, so
    the kernel's build and first launch never land on a request.
  * Route: the whole-unroll CUDA kernel (models/api policy) for l1/l1
    and for trained elementwise proxes; the plain loop for general B,
    group_l2 and ``kernel="reference"``.

Runs on CUDA unless the caller asks for the CPU (``device="cpu"`` or
``DLADMM_PLATFORM=cpu``; utils/platform.py).

Later slices (ROADMAP.md): bf16 / int8 serving (``dtype``), restoring a
training checkpoint (``--ckpt-dir``), the sharded server (``--sharded``)
and one CUDA Graph per bucket.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from dladmm_tpu_torch.models.api import KERNELS, kernel_route, resolve_forward
from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
from dladmm_tpu_torch.ops.cuda_unroll import (
    make_unrolled_inference_prox,
    prox_megakernel_available,
)
from dladmm_tpu_torch.ops.reference import make_cached_step
from dladmm_tpu_torch.utils.platform import resolve_device

_LATER = "is not ported yet; it is a later slice of the port (ROADMAP.md §1)"


def _buckets(max_batch: int) -> Tuple[int, ...]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def _prep_serving(params, A, B, dtype, layers, device):
    """Shared serving preamble: early-exit layer slice, then every
    tensor as contiguous float32 on ``device``. Returns (params, A, B)."""
    if dtype not in (None, "float32", torch.float32):
        raise NotImplementedError(f"serving dtype={dtype!r} {_LATER}")
    if layers is not None:
        K = params.W1.shape[0]
        if not 1 <= layers <= K:
            raise ValueError(f"layers must be in [1, {K}], got {layers}")
        params = DLADMMParams(*(v[:layers] for v in params))

    def put(t):
        return torch.as_tensor(t).detach().to(device, torch.float32).contiguous()

    params = DLADMMParams(*(put(v) for v in params))
    return params, put(A), None if B is None else put(B)


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

        device: ``cuda`` unless asked otherwise (utils/platform.py)."""
        self.device = resolve_device(device)
        params, A, B = _prep_serving(params, A, B, dtype, layers, self.device)
        if kernel not in KERNELS:
            raise ValueError(f"kernel={kernel!r}; the port offers {KERNELS}")
        if prox_pair is not None:
            if B is not None:
                raise ValueError(
                    "prox_pair requires identity B (the kernel "
                    "specializes B = I); pass step_fn for general B"
                )
            if step_fn is None:
                step_fn = make_cached_step(*prox_pair)
        if step_fn is not None:
            allowed = (
                KERNELS if prox_pair is not None else ("auto", "reference")
            )
            if kernel not in allowed:
                raise ValueError(
                    f"kernel={kernel!r} does not apply to general-prox "
                    f"serving (allowed here: {allowed}); the kernel "
                    "path needs the prox CALLABLES (prox_pair)"
                )
        if B is not None and kernel not in ("auto", "reference"):
            raise ValueError(
                f"kernel={kernel!r} requires identity B; general-B "
                "serving runs the plain loop"
            )
        m, n = A.shape
        d = params.W2.shape[1]
        self.params = params
        self.A = A
        self.B = B
        self.m = m
        self.buckets = tuple(sorted(buckets or _buckets(max_batch)))
        self._forward = {}
        self.routes = {}
        for S in self.buckets:
            if B is None and step_fn is None:
                fn, desc = resolve_forward(
                    m, n, d, S, kernel=kernel, device=self.device
                )
            elif B is None:
                avail, why = prox_megakernel_available(prox_pair, m, d)
                use_kernel = avail and kernel in ("auto", "megakernel")
                if kernel == "megakernel" and not use_kernel:
                    raise ValueError(
                        f"prox kernel unavailable at bucket {S} (m={m}, "
                        f"n={n}): {why}; use kernel='auto'"
                    )
                if use_kernel:
                    fn = make_unrolled_inference_prox(*prox_pair)
                    desc = kernel_route(self.device) + "-prox"
                else:
                    fn = functools.partial(dladmm_forward, step_fn=step_fn)
                    desc = "plain-loop-prox"
            else:
                fn = functools.partial(dladmm_forward, B=B, step_fn=step_fn)
                desc = "plain-loop-general-B"
            self._forward[S] = fn
            self.routes[S] = desc
        # Run every bucket once now: the kernel's build and first launch
        # happen here, never on a request.
        for S in self.buckets:
            self._run(S, torch.zeros((S, m), device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _bucket_for(self, S: int) -> int:
        for b in self.buckets:
            if S <= b:
                return b
        raise ValueError(
            f"batch {S} exceeds max bucket {self.buckets[-1]}"
        )

    def _run(self, bucket: int, b: Tensor):
        with torch.no_grad():
            return self._forward[bucket](self.params, self.A, b)[:2]

    def solve(self, b) -> Tuple[Tensor, Tensor]:
        """b (S, m), a tensor or an array -> (x (S, n), z (S, d)) on the
        server's device; pads to the bucket size and slices back. Rows
        are independent, so results are exact."""
        b = torch.as_tensor(b)
        if b.ndim != 2 or b.shape[1] != self.m:
            raise ValueError(f"expected (S, {self.m}), got {tuple(b.shape)}")
        S = b.shape[0]
        bucket = self._bucket_for(S)
        b = b.to(self.device, torch.float32)
        if bucket != S:
            b = torch.cat([b, b.new_zeros((bucket - S, self.m))])
        x, z = self._run(bucket, b.contiguous())
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
        """Enqueue a (s, m) request (s <= the largest bucket); returns a
        concurrent.futures.Future resolving to numpy (x (s, n), z (s, d))."""
        from concurrent.futures import Future

        if self._closed:
            raise RuntimeError("BatchingServer is closed")
        b = np.asarray(b, dtype=np.float32)
        if b.ndim != 2 or b.shape[1] != self.server.m:
            raise ValueError(f"expected (s, {self.server.m}), got {b.shape}")
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
        bs = np.concatenate([b for b, _ in window])
        try:
            x, z = self.server.solve(torch.from_numpy(bs))
            x, z = x.cpu().numpy(), z.cpu().numpy()
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
        "--ckpt-dir", help="training checkpoint dir (not ported yet)"
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
        help="serving precision (only float32 is ported yet)",
    )
    ap.add_argument("--kernel", choices=list(KERNELS), default="auto")
    ap.add_argument(
        "--layers",
        type=int,
        default=None,
        help="early exit: serve only the first k trained layers",
    )
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument(
        "--sharded", action="store_true", help="sharded serving (not ported yet)"
    )
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        ap.error(f"--ckpt-dir (training checkpoint restore) {_LATER}; use --import-torch")
    if args.dtype != "float32":
        ap.error(f"--dtype={args.dtype} {_LATER}")
    if args.sharded:
        ap.error(f"--sharded {_LATER}")

    device = resolve_device()
    cfg = get_config(args.config)
    A, B = problem_matrices(cfg, device=device)
    # General-prox configs: the served forward must run the SAME prox
    # pair the model was trained with.
    prox = resolve_prox(cfg.problem)
    step_fn = None if prox is None else make_cached_step(*prox)
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
    # One-shot CLI: a single bucket covering the whole request set.
    t_build = time.monotonic()
    server = InferenceServer(
        params,
        A,
        max_batch=max_batch,
        kernel=args.kernel,
        buckets=(max_batch,),
        layers=args.layers,
        B=B,
        step_fn=step_fn,
        prox_pair=prox if (prox is not None and B is None) else None,
        device=device,
    )
    build_s = time.monotonic() - t_build

    t_solve = time.monotonic()
    x, z = server.solve(requests)
    x, z = x.cpu(), z.cpu()  # waits for the device
    solve_s = time.monotonic() - t_solve

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
