"""Error model of shafa_tpu_torch (copy of shafa_tpu/errors.py:1-85).

Mirrors the reference's 9-value error enum (reference: src/modules/utils/errors.h:5-16)
and its message table (src/modules/utils/errors.c:12-20) so the CLI surface is
drop-in compatible: same codes, same stderr strings, exit status 1 on any error
(src/shafa.c:310-316).

Unlike the reference (which transports error ints through thread return values,
errors.h:5-6), we use a normal exception hierarchy: errors surface from the
backend's batched calls and host IO directly.
"""

from __future__ import annotations

import enum


class Code(enum.IntEnum):
    """Error codes, numerically identical to the reference enum."""

    SUCCESS = 0
    OUTSIDE_MODULE = 1
    LACK_OF_MEMORY = 2
    FILE_INACCESSIBLE = 3
    FILE_UNRECOGNIZABLE = 4
    FILE_STREAM_FAILED = 5
    FILE_TOO_SMALL = 6
    THREAD_CREATION_FAILED = 7
    THREAD_TERMINATION_FAILED = 8


#: Messages identical to the reference's error_msg() table (errors.c:12-20).
MESSAGES = {
    Code.SUCCESS: "No error\n",
    Code.LACK_OF_MEMORY: "Not enough memory for allocation\n",
    Code.FILE_INACCESSIBLE: (
        "File can't be accessed. Either lack of permissions or file doesn't exist\n"
    ),
    Code.FILE_UNRECOGNIZABLE: "File not recognized\n",
    Code.FILE_STREAM_FAILED: "Can't communicate properly with file's stream\n",
    Code.FILE_TOO_SMALL: "File too small for decompression\n",
    Code.THREAD_CREATION_FAILED: "Thread couldn't be created\n",
    Code.THREAD_TERMINATION_FAILED: "Thread didn't terminate properly\n",
}


def error_msg(code: int) -> str:
    """Reference-compatible message lookup (errors.c:26-36)."""
    try:
        return MESSAGES[Code(code)]
    except (ValueError, KeyError):
        return "Unknown error"


class ShafaError(Exception):
    """Base error; carries a reference-compatible code."""

    code: Code = Code.OUTSIDE_MODULE

    def __init__(self, detail: str = ""):
        super().__init__(detail or error_msg(self.code).strip())
        self.detail = detail


class OutsideModuleError(ShafaError):
    """CLI-level misuse; message already printed by the caller (shafa.c:310-312)."""

    code = Code.OUTSIDE_MODULE


class FileInaccessibleError(ShafaError):
    code = Code.FILE_INACCESSIBLE


class FileUnrecognizableError(ShafaError):
    code = Code.FILE_UNRECOGNIZABLE


class FileStreamError(ShafaError):
    code = Code.FILE_STREAM_FAILED


class FileTooSmallError(ShafaError):
    code = Code.FILE_TOO_SMALL
