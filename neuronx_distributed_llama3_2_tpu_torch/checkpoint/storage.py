"""Checkpoint storage: the tag protocol and its backends.

A copy of ``neuronx_distributed_llama3_2_tpu/checkpoint/storage.py`` (which
imports no JAX), so that a tag written by either package is listed, checked
and collected the same way by the other:

- ``BaseCheckpointStorage``: a tag is a directory with a ``checkpoint``
  marker, valid once its ``done`` marker exists; ``list_tags`` orders tags
  by ``meta.json``'s ``save_seq``; ``garbage_collect_incomplete`` removes
  tags that never got ``done``; ``remove_tag`` drops ``done`` first;
- ``FilesysCheckpointStorage``: a local or network directory, each file
  written to a ``.tmp`` name and renamed into place;
- ``S3CheckpointStorage``: behind an import of boto3, which raises a clear
  ImportError where boto3 is not installed;
- ``create_checkpoint_storage``: ``s3://`` roots go to S3, the rest to the
  file system.
"""

from __future__ import annotations

import json
import os
import shutil
from abc import ABC, abstractmethod
from typing import List, Optional

# marker filenames (reference checkpoint_storage.py:41-45 / checkpoint.py:62-89)
CHECKPOINT_MARKER = "checkpoint"  # written first: "a save started here"
DONE_MARKER = "done"  # written last: "this tag is complete and valid"


class BaseCheckpointStorage(ABC):
    def __init__(self, dirname: str):
        self._dirname = dirname

    def dirname(self) -> str:
        return self._dirname

    @abstractmethod
    def file_exists(self, filename: str) -> bool: ...

    @abstractmethod
    def dir_exists(self, dirname: str) -> bool: ...

    @abstractmethod
    def listdir(self, dirname: str) -> List[str]: ...

    @abstractmethod
    def remove_dir(self, dirname: str) -> None: ...

    @abstractmethod
    def remove_file(self, filename: str) -> None: ...

    @abstractmethod
    def save_text(self, text: str, filename: str) -> None: ...

    @abstractmethod
    def load_text(self, filename: str) -> str: ...

    @abstractmethod
    def save_bytes(self, data: bytes, filename: str) -> None: ...

    @abstractmethod
    def load_bytes(self, filename: str) -> bytes: ...

    @abstractmethod
    def makedirs(self, dirname: str) -> None: ...

    # -- tag protocol (shared logic) ------------------------------------

    def save_json(self, obj, filename: str) -> None:
        self.save_text(json.dumps(obj), filename)

    def load_json(self, filename: str):
        return json.loads(self.load_text(filename))

    def mark_checkpoint(self, tag: str) -> None:
        self.save_text("1", os.path.join(str(tag), CHECKPOINT_MARKER))

    def mark_done(self, tag: str) -> None:
        self.save_text("1", os.path.join(str(tag), DONE_MARKER))

    def is_done(self, tag: str) -> bool:
        return self.file_exists(os.path.join(str(tag), DONE_MARKER))

    def unmark_done(self, tag: str) -> None:
        """Invalidate a tag before overwriting it (reference delete removes
        ``done`` first, trainer/checkpoint.py:236-241) so an interrupted
        overwrite is garbage-collected instead of read as a torn mix."""
        marker = os.path.join(str(tag), DONE_MARKER)
        if self.file_exists(marker):
            self.remove_file(marker)

    def list_tags(self, completed_only: bool = True) -> List[str]:
        """Tags under the root, oldest-first by save order. A tag is a
        directory containing a ``checkpoint`` marker; only tags with a
        ``done`` marker are valid (reference checkpoint.py:62-89)."""
        if not self.dir_exists(""):
            return []
        tags = []
        for name in self.listdir(""):
            if not self.dir_exists(name):
                continue
            if not self.file_exists(os.path.join(name, CHECKPOINT_MARKER)):
                continue
            if completed_only and not self.is_done(name):
                continue
            tags.append(name)

        def order(tag):
            try:
                meta = self.load_json(os.path.join(tag, "meta.json"))
                return (meta.get("save_seq", 0), meta.get("saved_at", 0.0))
            except Exception:
                return (0, 0.0)

        tags.sort(key=order)
        return tags

    def garbage_collect_incomplete(self) -> List[str]:
        """Remove tags that started a save but never completed (interrupted
        before ``done``; reference GC, checkpoint.py:62-89)."""
        removed = []
        for tag in self.list_tags(completed_only=False):
            if not self.is_done(tag):
                self.remove_tag(tag)
                removed.append(tag)
        return removed

    def remove_tag(self, tag: str) -> None:
        """Delete removes ``done`` first so a crash mid-delete leaves a
        garbage-collectable (not a valid-looking) tag (reference
        checkpoint.py:236-241)."""
        done = os.path.join(str(tag), DONE_MARKER)
        if self.file_exists(done):
            self.remove_file(done)
        self.remove_dir(str(tag))


class FilesysCheckpointStorage(BaseCheckpointStorage):
    """Local/NFS directory backend (reference checkpoint_storage.py:120)."""

    def _p(self, name: str) -> str:
        return os.path.join(self._dirname, name) if name else self._dirname

    def file_exists(self, filename: str) -> bool:
        return os.path.isfile(self._p(filename))

    def dir_exists(self, dirname: str) -> bool:
        return os.path.isdir(self._p(dirname))

    def listdir(self, dirname: str) -> List[str]:
        return os.listdir(self._p(dirname))

    def remove_dir(self, dirname: str) -> None:
        shutil.rmtree(self._p(dirname), ignore_errors=True)

    def remove_file(self, filename: str) -> None:
        try:
            os.remove(self._p(filename))
        except FileNotFoundError:
            pass

    def makedirs(self, dirname: str) -> None:
        os.makedirs(self._p(dirname), exist_ok=True)

    def save_text(self, text: str, filename: str) -> None:
        self.save_bytes(text.encode(), filename)

    def load_text(self, filename: str) -> str:
        return self.load_bytes(filename).decode()

    def save_bytes(self, data: bytes, filename: str) -> None:
        path = self._p(filename)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # atomic-rename write so readers never see partial files
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def load_bytes(self, filename: str) -> bytes:
        with open(self._p(filename), "rb") as f:
            return f.read()


class S3CheckpointStorage(BaseCheckpointStorage):
    """S3 backend (reference checkpoint_storage.py:219). Requires boto3."""

    def __init__(self, dirname: str):
        super().__init__(dirname)
        try:
            import boto3  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "s3:// checkpoint paths require boto3, which is not installed"
            ) from e
        from urllib.parse import urlparse

        parsed = urlparse(dirname)
        self._bucket = parsed.netloc
        self._prefix = parsed.path.lstrip("/")
        self._client = boto3.client("s3")

    def _key(self, name: str) -> str:
        return f"{self._prefix}/{name}" if name else self._prefix

    def file_exists(self, filename: str) -> bool:
        import botocore

        try:
            self._client.head_object(Bucket=self._bucket, Key=self._key(filename))
            return True
        except botocore.exceptions.ClientError as e:
            # only a true 404 means "absent"; throttling/5xx/403 must not be
            # mistaken for a missing 'done' marker (GC would delete a valid
            # checkpoint)
            code = e.response.get("ResponseMetadata", {}).get("HTTPStatusCode")
            if code == 404 or e.response.get("Error", {}).get("Code") in (
                "404",
                "NoSuchKey",
                "NotFound",
            ):
                return False
            raise

    def dir_exists(self, dirname: str) -> bool:
        resp = self._client.list_objects_v2(
            Bucket=self._bucket, Prefix=self._key(dirname) + "/", MaxKeys=1
        )
        return resp.get("KeyCount", 0) > 0

    def listdir(self, dirname: str) -> List[str]:
        prefix = self._key(dirname) + "/" if dirname else self._prefix + "/"
        names = set()
        paginator = self._client.get_paginator("list_objects_v2")
        for page in paginator.paginate(
            Bucket=self._bucket, Prefix=prefix, Delimiter="/"
        ):
            for cp in page.get("CommonPrefixes", []):
                names.add(cp["Prefix"][len(prefix):].rstrip("/"))
            for obj in page.get("Contents", []):
                names.add(obj["Key"][len(prefix):])
        return sorted(n for n in names if n)

    def remove_dir(self, dirname: str) -> None:
        prefix = self._key(dirname) + "/"
        paginator = self._client.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=self._bucket, Prefix=prefix):
            objs = [{"Key": o["Key"]} for o in page.get("Contents", [])]
            if objs:
                self._client.delete_objects(
                    Bucket=self._bucket, Delete={"Objects": objs}
                )

    def remove_file(self, filename: str) -> None:
        self._client.delete_object(Bucket=self._bucket, Key=self._key(filename))

    def makedirs(self, dirname: str) -> None:
        pass  # S3 has no directories

    def save_text(self, text: str, filename: str) -> None:
        self.save_bytes(text.encode(), filename)

    def load_text(self, filename: str) -> str:
        return self.load_bytes(filename).decode()

    def save_bytes(self, data: bytes, filename: str) -> None:
        self._client.put_object(
            Bucket=self._bucket, Key=self._key(filename), Body=data
        )

    def load_bytes(self, filename: str) -> bytes:
        resp = self._client.get_object(
            Bucket=self._bucket, Key=self._key(filename)
        )
        return resp["Body"].read()


def create_checkpoint_storage(dirname: str) -> BaseCheckpointStorage:
    """reference checkpoint_storage.py:558."""
    if str(dirname).startswith("s3://"):
        return S3CheckpointStorage(dirname)
    return FilesysCheckpointStorage(dirname)
