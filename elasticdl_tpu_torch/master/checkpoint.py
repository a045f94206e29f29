"""Checkpoints: the model file and the checkpoint service.

The reference's `elasticdl_tpu/master/checkpoint.py`:

- `save_model_file` / `load_model_file`: the payload `{"version",
  "params", "aux"[, "embeddings"][, "opt_state"]}` in the reference's
  codec frame (`codec.dumps_v2`), written to a temporary file and
  renamed into place, so a reader never sees a partial file.
  `embeddings` is the embedding store's snapshot, `{table: {id: row}}`,
  the sparse optimizer's slot tables included; `opt_state` is the dense
  optimizer's flat state leaves (`{"kind": "single", "leaves": [...]}`,
  or with the sharded PS each shard's: `{"kind": "sharded", "shards":
  [leaves, ...]}`), so a resumed job continues its momentum or Adam
  moments instead of restarting them cold. A file that either package
  writes loads in the other.
- `CheckpointService`: durable checkpoints every `checkpoint_steps`
  versions (floor crossing, so a multi-step bump cannot skip one),
  written by a bounded background writer and rotated to
  `keep_checkpoint_max` files (`model_v{version}.ckpt`), with the
  embedding store's snapshot taken when the save is triggered; and ephemeral
  evaluation snapshots, written synchronously in their own directory,
  which pin a version for an evaluation job and serve its FIXED pulls.

A directory that is not given is a fresh temporary one, made when the
first file is written (the eval snapshots' always is), so the
reference's `include_evaluation` switch is not needed.
"""

from __future__ import annotations

import os
import queue
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.common.messages import Model

logger = get_logger(__name__)


def save_model_file(path: str, params: Any, version: int, aux: Any = None,
                    embeddings: Optional[Dict] = None, opt_state: Any = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"version": version, "params": params, "aux": aux}
    if embeddings is not None:
        payload["embeddings"] = embeddings
    if opt_state is not None:
        payload["opt_state"] = opt_state
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(codec.dumps_v2(payload))
    os.replace(tmp, path)


def load_model_file(path: str) -> Model:
    """The file's model; its `embeddings` and `opt_state` (None when the
    file has none) ride on the returned Model."""
    with open(path, "rb") as f:
        d = codec.loads(f.read())
    m = Model(version=d["version"], params=d["params"], aux=d.get("aux"))
    m.embeddings = d.get("embeddings")
    m.opt_state = d.get("opt_state")
    return m


def restore_for_init(path: str, optimizer, embedding_store=None,
                     ps_group=None) -> Tuple[Any, Any, int]:
    """(params, aux, version) of the checkpoint at `path` for a PS to boot
    from. On the single PS, `optimizer` (a PSOptimizer) adopts the file's
    single-PS optimizer state, so the resumed job continues its momentum
    or Adam moments instead of starting them cold. With `ps_group` (the
    sharded PS) each shard is seeded with its slice and adopts its own
    state from a sharded file, which needs the same shard count (slices
    do not re-split). Any other pairing leaves the optimizer cold, with a
    warning, as the reference does. The file's embedding tables go into
    `embedding_store` when it is given."""
    model = load_model_file(path)
    if embedding_store is not None and model.embeddings:
        embedding_store.restore(model.embeddings)
    opt_state = model.opt_state
    kind = opt_state.get("kind") if opt_state else None
    restored = False
    if ps_group is not None:
        ps_group.ensure_init(codec.ravel_np(model.params), model.version)
        if kind == "sharded":
            try:
                ps_group.restore_opt(opt_state["shards"])
                restored = True
            except ValueError as e:
                logger.warning("optimizer state not restored (%s)", e)
    elif kind == "single":
        optimizer.restore_state(model.params, opt_state["leaves"])
        restored = True
    if restored:
        logger.info("Initialized model v%d and its optimizer state (%s) from %s",
                    model.version, kind, path)
    else:
        logger.warning("Initialized model v%d from %s without its optimizer state "
                       "(%r, on %s): the optimizer starts cold, the resume is not exact",
                       model.version, path, kind,
                       "PS shards" if ps_group is not None else "the single PS")
    return model.params, model.aux, model.version


class CheckpointService:
    def __init__(
        self,
        checkpoint_dir: str = "",
        checkpoint_steps: int = 0,
        keep_checkpoint_max: int = 0,
        embedding_store=None,
    ):
        self._directory = checkpoint_dir
        self._embedding_store = embedding_store
        self._steps = checkpoint_steps
        self._max_versions = keep_checkpoint_max
        self._eval_checkpoint_dir = ""
        self._dir_lock = threading.Lock()
        self._checkpoint_list: List[str] = []
        self._eval_models: Dict[int, str] = {}
        # Durable saves are triggered from a report handler with a
        # snapshot copied under the servicer lock; the write runs on a
        # background thread so it never stalls that worker's response.
        # The queue is bounded (each item is a full copy of the model):
        # a disk slower than the cadence blocks `save` instead of
        # piling copies up. Eval snapshots stay synchronous: a worker
        # may pull the pinned version the moment it gets the task. A
        # write failure is logged, never raised into training.
        self._write_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._writer: Optional[threading.Thread] = None
        self._writer_lock = threading.Lock()
        # flush() waits on counters, not queue.join(), which would also
        # wait for saves enqueued after the call
        self._write_cv = threading.Condition()
        self._enqueued = 0
        self._written = 0

    def is_enabled(self) -> bool:
        return bool(self._steps)

    def crossed(self, prev_version: int, version: int) -> bool:
        """True when (prev_version, version] crossed a multiple of
        `checkpoint_steps`: a multi-step bump (a window sync) that jumps
        over the multiple saves once, at its post-bump version."""
        return self.is_enabled() and version // self._steps > prev_version // self._steps

    def _dir(self, is_eval: bool) -> str:
        with self._dir_lock:
            if is_eval:
                if not self._eval_checkpoint_dir:
                    self._eval_checkpoint_dir = tempfile.mkdtemp(prefix="edl_torch_evalckpt_")
                return self._eval_checkpoint_dir
            if not self._directory:
                self._directory = tempfile.mkdtemp(prefix="edl_torch_ckpt_")
            return self._directory

    def _path(self, version: int, is_eval: bool) -> str:
        return os.path.join(self._dir(is_eval), f"model_v{version}.ckpt")

    def save(self, params: Any, version: int, is_eval: bool = False, aux: Any = None,
             opt_state: Any = None):
        """Durable saves go to the background writer, with the embedding
        tables as they are now; eval snapshots (the dense model only) are
        written before this returns."""
        path = self._path(version, is_eval)
        if is_eval:
            save_model_file(path, params, version, aux=aux)
            self._eval_models[version] = path
            return
        emb = self._embedding_store.snapshot() if self._embedding_store is not None else None
        with self._writer_lock:
            # save() runs on the server's handler threads: two reports
            # crossing the cadence at once must not start two writers
            if self._writer is None:
                self._writer = threading.Thread(target=self._writer_loop, daemon=True)
                self._writer.start()
        with self._write_cv:
            self._enqueued += 1
        self._write_q.put((path, params, version, aux, emb, opt_state))

    def _writer_loop(self):
        while True:
            item = self._write_q.get()
            if item is None:
                return
            try:
                path, params, version, aux, emb, opt_state = item
                save_model_file(path, params, version, aux=aux, embeddings=emb,
                                opt_state=opt_state)
                logger.info("Checkpoint saved: %s", path)
                self._checkpoint_list.append(path)
                if self._max_versions:
                    while len(self._checkpoint_list) > self._max_versions:
                        stale = self._checkpoint_list.pop(0)
                        try:
                            os.remove(stale)
                        except FileNotFoundError:
                            pass
            except Exception:
                logger.exception("checkpoint write failed (training continues)")
            finally:
                with self._write_cv:
                    self._written += 1
                    self._write_cv.notify_all()

    def flush(self):
        """Block until every write queued before this call has landed."""
        with self._write_cv:
            target = self._enqueued
            self._write_cv.wait_for(lambda: self._written >= target)

    def close(self):
        """Drain pending writes and stop the writer thread (a closed
        service can still save: the writer restarts lazily)."""
        self.flush()
        with self._writer_lock:
            writer, self._writer = self._writer, None
        if writer is not None:
            self._write_q.put(None)
            writer.join(timeout=30)

    # -- evaluation snapshots (FIXED model pulls) ----------------------------

    def get_eval_model(self, version: int) -> Optional[Model]:
        path = self._eval_models.get(version)
        if path is None or not os.path.exists(path):
            return None
        return load_model_file(path)

    def remove_eval_checkpoint(self, version: int):
        """Delete the pinned snapshot once its evaluation job completed."""
        path = self._eval_models.pop(version, None)
        if path:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass

    # -- lookup by version ---------------------------------------------------

    def load_version(self, version: int) -> Optional[Model]:
        path = self._path(version, is_eval=False)
        # writes land by rename, so an existing file is complete
        if not os.path.exists(path):
            self.flush()  # the version may still be in the write queue
        if not os.path.exists(path):
            return None
        return load_model_file(path)

    def latest_path(self) -> Optional[str]:
        self.flush()
        return self._checkpoint_list[-1] if self._checkpoint_list else None
