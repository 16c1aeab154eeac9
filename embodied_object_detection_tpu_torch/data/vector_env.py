"""Multi-process environment pool for dataset generation.

The port's copy of the JAX package's `data/vector_env.py` (ref: habitat-lab
habitat/core/vector_env.py:71-537: VectorEnv, one simulator per forked or
spawned worker process with pipe-based async step, pause/resume, and a
ThreadedVectorEnv variant). The reference uses it only to generate the
embodied dataset; the detector never touches it. It drives any picklable
env factories (such as the synthetic scene renderer) with the same API:

    envs = VectorEnv([make_env_fn] * 8)
    obs = envs.reset()
    envs.async_step(actions); obs = envs.wait_step()
    envs.pause_at(2); envs.resume_all(); envs.close()
"""

from __future__ import annotations

import multiprocessing as mp
import threading
import queue as queue_mod
from typing import Any, Callable, List, Optional, Sequence

_STEP = "step"
_RESET = "reset"
_CLOSE = "close"
_CALL = "call"


def _do_step(env, action, auto_reset_done: bool):
    res = env.step(action)
    # Gym-tuple envs: auto-reset finished episodes in the worker so the
    # pool always yields fresh observations (ref: vector_env.py:184-190,
    # auto_reset_done=True default — relied on by the PPO trainers).
    if (auto_reset_done and isinstance(res, tuple) and len(res) == 4
            and res[2]):
        obs = env.reset()
        res = (obs, res[1], res[2], res[3])
    return res


def _worker(conn, env_fn, auto_reset_done=False):
    env = env_fn()
    try:
        while True:
            cmd, data = conn.recv()
            if cmd == _STEP:
                conn.send(_do_step(env, data, auto_reset_done))
            elif cmd == _RESET:
                conn.send(env.reset())
            elif cmd == _CALL:
                name, args, kwargs = data
                attr = getattr(env, name)
                # non-callable attributes are returned directly, like
                # habitat's VectorEnv._worker_env (vector_env.py CALL_COMMAND)
                conn.send(attr(*args, **kwargs) if callable(attr) else attr)
            elif cmd == _CLOSE:
                if hasattr(env, "close"):
                    env.close()
                conn.close()
                return
    except (EOFError, KeyboardInterrupt):
        pass


class VectorEnv:
    """Process-parallel env pool (fork/spawn/forkserver start methods, like
    habitat's multiprocessing_start_method knob)."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]],
                 start_method: str = "fork", auto_reset_done: bool = False):
        ctx = mp.get_context(start_method)
        self._conns = []
        self._procs = []
        for fn in env_fns:
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_worker,
                               args=(child, fn, auto_reset_done),
                               daemon=True)
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)
        self._paused: List[tuple] = []
        self._awaiting = False

    @property
    def num_envs(self) -> int:
        return len(self._conns)

    def reset(self) -> List[Any]:
        for c in self._conns:
            c.send((_RESET, None))
        return [c.recv() for c in self._conns]

    def step(self, actions: Sequence[Any]) -> List[Any]:
        self.async_step(actions)
        return self.wait_step()

    def async_step(self, actions: Sequence[Any]):
        """ref: vector_env.py:356-373 (async_step / step_async)."""
        assert not self._awaiting
        for c, a in zip(self._conns, actions):
            c.send((_STEP, a))
        self._awaiting = True

    def wait_step(self) -> List[Any]:
        assert self._awaiting
        self._awaiting = False
        return [c.recv() for c in self._conns]

    def call(self, name: str, args_list: Optional[Sequence[tuple]] = None):
        """Call an arbitrary env method in every worker (vector_env `call`)."""
        args_list = args_list or [((), {})] * self.num_envs
        for c, (args, kwargs) in zip(self._conns, args_list):
            c.send((_CALL, (name, args, kwargs)))
        return [c.recv() for c in self._conns]

    def pause_at(self, index: int):
        """Remove an env from the active set (ref: vector_env.py:413-430)."""
        self._paused.append((index, self._conns.pop(index),
                             self._procs.pop(index)))

    def resume_all(self):
        for index, conn, proc in reversed(self._paused):
            self._conns.insert(index, conn)
            self._procs.insert(index, proc)
        self._paused = []

    def close(self):
        # Drain an in-flight async_step first (ref: vector_env.py:334-339):
        # a worker blocked in conn.send() on a result larger than the pipe
        # buffer never reads _CLOSE, so join() would time out and abandon
        # the process with env.close() unrun.
        if self._awaiting:
            for c in self._conns:
                try:
                    c.recv()
                except (EOFError, OSError):
                    pass
            self._awaiting = False
        for c in self._conns + [c for _, c, _ in self._paused]:
            try:
                c.send((_CLOSE, None))
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs + [p for _, _, p in self._paused]:
            p.join(timeout=5)
        self._conns, self._procs, self._paused = [], [], []

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class ThreadedVectorEnv(VectorEnv):
    """Thread-backed variant (ref: vector_env.py:527 ThreadedVectorEnv) —
    for envs that can't fork (or debugging)."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]],
                 start_method: str = "fork", auto_reset_done: bool = False):
        self._envs = [fn() for fn in env_fns]
        self._queues = [queue_mod.Queue() for _ in env_fns]
        self._results = [queue_mod.Queue() for _ in env_fns]
        self._threads = []
        for env, q, r in zip(self._envs, self._queues, self._results):
            t = threading.Thread(target=self._loop,
                                 args=(env, q, r, auto_reset_done),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self._paused = []
        self._awaiting = False

    @staticmethod
    def _loop(env, q, r, auto_reset_done=False):
        while True:
            cmd, data = q.get()
            if cmd == _CLOSE:
                if hasattr(env, "close"):
                    env.close()
                return
            if cmd == _STEP:
                r.put(_do_step(env, data, auto_reset_done))
            elif cmd == _RESET:
                r.put(env.reset())
            elif cmd == _CALL:
                name, args, kwargs = data
                attr = getattr(env, name)
                r.put(attr(*args, **kwargs) if callable(attr) else attr)

    @property
    def num_envs(self):
        return len(self._queues)

    def reset(self):
        for q in self._queues:
            q.put((_RESET, None))
        return [r.get() for r in self._results]

    def async_step(self, actions):
        assert not self._awaiting
        for q, a in zip(self._queues, actions):
            q.put((_STEP, a))
        self._awaiting = True

    def wait_step(self):
        assert self._awaiting
        self._awaiting = False
        return [r.get() for r in self._results]

    def call(self, name, args_list=None):
        args_list = args_list or [((), {})] * self.num_envs
        for q, (args, kwargs) in zip(self._queues, args_list):
            q.put((_CALL, (name, args, kwargs)))
        return [r.get() for r in self._results]

    def pause_at(self, index):
        self._paused.append((index, self._queues.pop(index),
                             self._results.pop(index)))

    def resume_all(self):
        for index, q, r in reversed(self._paused):
            self._queues.insert(index, q)
            self._results.insert(index, r)
        self._paused = []

    def close(self):
        for q in self._queues + [q for _, q, _ in self._paused]:
            q.put((_CLOSE, None))
        self._queues, self._results, self._paused = [], [], []
        self._awaiting = False
