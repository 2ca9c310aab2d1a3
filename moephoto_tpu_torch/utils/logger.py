"""Logging setup: a human console handler and a rotating JSON-lines file
handler for the ``Moe`` logger."""

from __future__ import annotations

import json
import logging
import logging.config
import os


class JSONFormatter(logging.Formatter):
    def format(self, record):
        obj = {
            "t": self.formatTime(record),
            "level": record.levelname,
            "name": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj, ensure_ascii=False)


def initLogging(logPath: str = ".user/log.txt", level=logging.INFO):
    try:
        os.makedirs(os.path.dirname(logPath), exist_ok=True)
        fileHandler = {
            "class": "logging.handlers.RotatingFileHandler",
            "filename": logPath,
            "maxBytes": 1 << 24,
            "backupCount": 1,
            "formatter": "json",
            "encoding": "utf-8",
        }
        handlers = ["console", "file"]
    except OSError:
        fileHandler = None
        handlers = ["console"]
    cfg = {
        "version": 1,
        "disable_existing_loggers": False,
        "formatters": {
            "plain": {"format": "%(asctime)s %(levelname)s %(name)s %(message)s"},
            "json": {"()": JSONFormatter},
        },
        "handlers": {
            "console": {"class": "logging.StreamHandler", "formatter": "plain"},
        },
        "loggers": {"Moe": {"level": level, "handlers": handlers}},
    }
    if fileHandler:
        cfg["handlers"]["file"] = fileHandler
    try:
        logging.config.dictConfig(cfg)
    except ValueError:  # the log file cannot be opened: console only
        logging.basicConfig(level=level)
    return logging
