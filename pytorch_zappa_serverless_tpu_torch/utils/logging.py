"""Structured JSON logging: one-line JSON records on stdout.

Setting ``TPUSERVE_LOG_FILE`` additionally appends every record to that file.
Every record emitted while a traced request is being handled carries its
``trace_id`` (:data:`current_trace_id`), as the JAX package's records do.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import sys
import time

# The serving layer sets this for the duration of each traced request, so
# every record its handler emits carries the ``trace_id`` that
# /admin/trace and the metric exemplars use.  Background tasks (the batcher
# loop, the job workers) pass ``trace_id`` in ``fields`` instead.
current_trace_id: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "tpuserve_trace_id", default=None)


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(time.time(), 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "fields", None)
        if extra:
            out.update(extra)
        tid = current_trace_id.get()
        if tid and "trace_id" not in out:
            out["trace_id"] = tid
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(JsonFormatter())
        logger.addHandler(h)
        log_file = os.environ.get("TPUSERVE_LOG_FILE")
        if log_file:
            fh = logging.FileHandler(os.path.expanduser(log_file))
            fh.setFormatter(JsonFormatter())
            logger.addHandler(fh)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def log_event(logger: logging.Logger, msg: str, **fields):
    logger.info(msg, extra={"fields": fields})
