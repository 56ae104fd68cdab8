"""Filesystem abstraction — counterpart of
``paddle_tpu/distributed/fleet/utils/fs.py`` (the reference's
fleet/utils/fs.py).

``LocalFS`` is complete; ``HDFSClient`` shells out to the ``hadoop``
CLI, and where there is none every call raises an error naming the
missing binary, as the JAX package's does.
"""
from __future__ import annotations

import os
import shutil
import subprocess

__all__ = ["FS", "LocalFS", "HDFSClient"]


class FS:
    def ls_dir(self, path):
        raise NotImplementedError

    def is_file(self, path):
        raise NotImplementedError

    def is_dir(self, path):
        raise NotImplementedError

    def is_exist(self, path):
        raise NotImplementedError

    def mkdirs(self, path):
        raise NotImplementedError

    def delete(self, path):
        raise NotImplementedError

    def mv(self, src, dst, overwrite=False):
        raise NotImplementedError

    def touch(self, path, exist_ok=True):
        raise NotImplementedError


class LocalFS(FS):
    """reference fs.py LocalFS."""

    def ls_dir(self, path):
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for e in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, e))
             else files).append(e)
        return dirs, files

    def is_file(self, path):
        return os.path.isfile(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_exist(self, path):
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def mv(self, src, dst, overwrite=False, test_exists=True):
        if test_exists and not self.is_exist(src):
            raise FileNotFoundError(src)
        if self.is_exist(dst):
            if not overwrite:
                raise FileExistsError(dst)
            self.delete(dst)
        shutil.move(src, dst)

    def touch(self, path, exist_ok=True):
        if self.is_exist(path) and not exist_ok:
            raise FileExistsError(path)
        open(path, "a").close()

    def upload(self, local_path, fs_path):
        shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        shutil.copy(fs_path, local_path)

    def list_dirs(self, path):
        return self.ls_dir(path)[0]


class HDFSClient(FS):
    """reference fs.py HDFSClient — ``hadoop fs`` CLI wrapper."""

    def __init__(self, hadoop_home=None, configs=None, time_out=300000,
                 sleep_inter=1000):
        self._hadoop = (os.path.join(hadoop_home, "bin", "hadoop")
                        if hadoop_home else "hadoop")
        self._configs = configs or {}
        self._available = shutil.which(self._hadoop) is not None

    def _run(self, *args):
        if not self._available:
            raise RuntimeError(
                f"hadoop CLI not found ({self._hadoop!r}); HDFSClient needs "
                "a hadoop installation — use LocalFS for local checkpoints")
        cmd = [self._hadoop, "fs"]
        for k, v in self._configs.items():
            cmd += ["-D", f"{k}={v}"]
        cmd += list(args)
        out = subprocess.run(cmd, capture_output=True, text=True)
        return out.returncode, out.stdout

    def ls_dir(self, path):
        rc, out = self._run("-ls", path)
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = os.path.basename(parts[-1])
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def is_exist(self, path):
        rc, _ = self._run("-test", "-e", path)
        return rc == 0

    def is_file(self, path):
        rc, _ = self._run("-test", "-f", path)
        return rc == 0

    def is_dir(self, path):
        rc, _ = self._run("-test", "-d", path)
        return rc == 0

    def mkdirs(self, path):
        self._run("-mkdir", "-p", path)

    def delete(self, path):
        self._run("-rm", "-r", "-f", path)

    def mv(self, src, dst, overwrite=False):
        if overwrite:
            self.delete(dst)
        self._run("-mv", src, dst)

    def touch(self, path, exist_ok=True):
        self._run("-touchz", path)

    def upload(self, local_path, fs_path):
        self._run("-put", "-f", local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)
