"""Asyncio streaming front end over `ServingEngine`. Port of
`repro/serve/frontend.py`.

The engine's `step()` is synchronous and batched; this module turns it
into a service: continuous request intake, a token stream per request
(an async iterator that yields each token in the step that sampled it,
the prefill token included), and step-level SLO records through a
`serve.metrics.MetricsLedger`. Admission is the engine's own: paged mode
reserves a request's worst-case pages all or nothing before it leaves
the queue, so the front end never admits what the pool cannot finish.

    engine = ServingEngine(model, params, EngineCfg(...))
    ledger = MetricsLedger()
    async with AsyncFrontend(engine, metrics=ledger) as fe:
        stream = fe.submit(prompt, max_new_tokens=32)
        async for tok in stream:          # in the step that sampled it
            print(tok)
    print(ledger.snapshot()["ttft_s"])    # the TTFT distribution

Design (docs/serving.md describes the reference's, which this follows):

- ONE serve-loop task drives the engine. Each turn moves the intake into
  the engine queue, runs `engine.step()` in the front end's own
  one-thread executor (the event loop stays live while the card works,
  so consumers read their streams during a step), then publishes the
  step's `StepEvents` to the streams and the ledger. Submissions wait in
  `_intake` and join the queue at the next step boundary, so no lock
  guards the engine.
- One thread runs every step. The current CUDA stream, the current
  device and a graph capture's mode belong to a thread, so the engine's
  first run of each compiled step (its capture) and every replay happen
  on that one thread, created in `start()` and shut down in `aclose()`.
  The loop thread touches no CUDA API: `_publish` and the ledger read
  host state only.
- A stream yields its tokens in sampling order and finishes (its
  `finish_reason` set) after its last token. A step that raises ends the
  serve loop: `submit` and `drain` re-raise the error, and every stream
  still open raises at its next read instead of waiting forever.
- When the engine drains, the loop parks on an event; `submit()` wakes
  it, and `drain()` waits for the parked state.
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.engine import ServingEngine, StepEvents

_DONE = object()    # the terminal marker after a stream's last token
_FAILED = object()  # the serve loop ended before the stream finished


class TokenStream:
    """One request's async token stream.

    `async for tok in stream` yields each sampled token (ints) in
    sampling order and stops after the last; `finish_reason` ("eos",
    "max_new_tokens" or "length_cap") is set before the iteration ends.
    `tokens` holds what was yielded so far, `uid` is assigned when the
    request enters the engine queue (the next step boundary after
    `submit`), and `queue_position` is the submission index on this
    front end (from 0).
    """

    def __init__(self, queue_position: int):
        self.uid: Optional[int] = None
        self.queue_position = queue_position
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.done = False
        self._q: asyncio.Queue = asyncio.Queue()

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        if self.done and self._q.empty():
            raise StopAsyncIteration
        item = await self._q.get()
        if item is _DONE:
            self.done = True
            raise StopAsyncIteration
        if item is _FAILED:
            raise RuntimeError("AsyncFrontend serve loop exited before "
                               "this stream finished")
        return item


class AsyncFrontend:
    """Async serving shell: continuous intake, streaming, SLO metrics.

    Use as an async context manager (`async with AsyncFrontend(...)`),
    or call `start()` from a running event loop and `aclose()` when
    done. `aclose()` finishes all queued and running work first: closing
    drains, it never aborts.
    """

    def __init__(self, engine: ServingEngine,
                 metrics: Optional[object] = None):
        self.engine = engine
        self.metrics = metrics
        self._intake: Deque[Tuple[TokenStream, np.ndarray, int]] = \
            collections.deque()
        self._streams: Dict[int, TokenStream] = {}
        self._submitted = 0
        self._task: Optional[asyncio.Task] = None
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = \
            None
        self._closing = False
        self._wake: Optional[asyncio.Event] = None
        self._idle: Optional[asyncio.Event] = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Start the step thread and the serve-loop task on the running
        event loop."""
        if self._task is not None:
            raise RuntimeError("AsyncFrontend already started")
        loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        self._idle = asyncio.Event()
        self._idle.set()
        dev, init, args = self.engine.device, None, ()
        if dev.type == "cuda":      # the step thread's device: the engine's
            init, args = torch.cuda.set_device, (
                torch.cuda.current_device() if dev.index is None
                else dev.index,)
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repro-torch-step",
            initializer=init, initargs=args)
        self._task = loop.create_task(self._serve_loop(),
                                      name="repro-torch-serve-loop")

    async def __aenter__(self) -> "AsyncFrontend":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    async def aclose(self) -> None:
        """Drain the remaining work, then stop the serve loop and the step
        thread. Re-raises the error the loop ended on, if any."""
        if self._task is None:
            return
        self._closing = True
        self._wake.set()
        try:
            await self._task
        finally:
            self._task = None
            self._executor.shutdown(wait=True)
            self._executor = None

    async def drain(self) -> None:
        """Wait until no request is queued, prefilling or decoding. The
        streams submitted before the call are complete when it returns;
        the front end stays open for more. A step that raises while it
        waits re-raises here."""
        self._require_running()
        idle = asyncio.ensure_future(self._idle.wait())
        try:
            await asyncio.wait((idle, self._task),
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            idle.cancel()
        self._require_running()

    # ------------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens: int = 16) -> TokenStream:
        """Queue one request; returns its `TokenStream` at once. The
        request joins the engine queue at the next step boundary, and
        the engine admits it as the drained loop would. Call it from the
        loop's thread, like every front-end method."""
        self._require_running()
        if self._closing:
            raise RuntimeError("AsyncFrontend is closing")
        stream = TokenStream(queue_position=self._submitted)
        self._submitted += 1
        self._intake.append((stream, np.asarray(prompt, np.int32),
                             max_new_tokens))
        self._idle.clear()
        self._wake.set()
        return stream

    @property
    def completed(self):
        """Completed `Request`s in completion order (the engine's)."""
        return self.engine.completed

    # --------------------------------------------------------- serve loop
    def _require_running(self) -> None:
        if self._task is None:
            raise RuntimeError(
                "AsyncFrontend is not running: use `async with "
                "AsyncFrontend(engine) as fe:` or call start() first")
        if self._task.done():
            # a crashed serve loop raises here, at the caller
            self._task.result()
            raise RuntimeError("AsyncFrontend serve loop has exited")

    def _flush_intake(self) -> None:
        """Move the buffered submissions into the engine queue (between
        steps, on the loop's thread)."""
        while self._intake:
            stream, prompt, max_new = self._intake.popleft()
            stream.uid = self.engine.submit(prompt, max_new)
            self._streams[stream.uid] = stream

    def _has_work(self) -> bool:
        return bool(self._intake) or self.engine.has_work()

    async def _serve_loop(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                self._flush_intake()
                if not self._has_work():
                    self._idle.set()
                    if self._closing:
                        return
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                self._idle.clear()
                ev = await loop.run_in_executor(self._executor,
                                                self.engine.step)
                self._publish(ev)
        finally:
            # only a raising step leaves streams open: fail them
            for stream, _, _ in self._intake:
                stream._q.put_nowait(_FAILED)
            for stream in self._streams.values():
                if stream.finish_reason is None:
                    stream._q.put_nowait(_FAILED)

    def _publish(self, ev: StepEvents) -> None:
        """Fan one step's token events out to their streams and the
        ledger: the only reader of `StepEvents` here."""
        for te in ev.tokens:
            stream = self._streams.get(te.uid)
            if stream is None:
                continue    # submitted on the engine directly: no stream
            stream.tokens.append(te.token)
            stream._q.put_nowait(te.token)
            if te.done:
                stream.finish_reason = te.finish_reason
                stream._q.put_nowait(_DONE)
        if self.metrics is not None:
            self.metrics.on_step(ev, self.engine)
