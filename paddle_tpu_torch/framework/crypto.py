"""Encrypted model save and load — counterpart of
``paddle_tpu/framework/crypto.py`` (the reference's framework/io/crypto/).

The same cipher and file layout as the JAX package's, so a blob either
package writes decrypts in the other: a SHA256-CTR keystream XOR with
HMAC-SHA256 encrypt-then-MAC, a random 16-byte nonce per file, the key
normalized as ``sha256(b"paddle_tpu-enc" + key)``.

File layout: magic(8) ``PTENC\\x00\\x01\\x00`` | nonce(16) | ciphertext |
hmac(32).  :func:`save_encrypted` pickles a tree whose tensors (torch or
numpy) are stored as numpy arrays.  Imports no torch at module level.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import pickle
import struct

_MAGIC = b"PTENC\x00\x01\x00"


def _keystream(key: bytes, nonce: bytes, nbytes: int) -> bytes:
    n_blocks = (nbytes + 31) // 32
    prefix = key + nonce
    return b"".join(
        hashlib.sha256(prefix + struct.pack("<Q", c)).digest()
        for c in range(n_blocks))[:nbytes]


def _xor(data: bytes, ks: bytes) -> bytes:
    import numpy as np

    # vectorized: a 500MB model must not take minutes of per-byte Python
    a = np.frombuffer(data, np.uint8)
    b = np.frombuffer(ks, np.uint8)
    return np.bitwise_xor(a, b).tobytes()


def _norm_key(key: bytes | str) -> bytes:
    if isinstance(key, str):
        key = key.encode()
    return hashlib.sha256(b"paddle_tpu-enc" + key).digest()


def encrypt_bytes(data: bytes, key: bytes | str) -> bytes:
    k = _norm_key(key)
    nonce = os.urandom(16)
    ct = _xor(data, _keystream(k, nonce, len(data)))
    mac = hmac.new(k, _MAGIC + nonce + ct, hashlib.sha256).digest()
    return _MAGIC + nonce + ct + mac


def decrypt_bytes(blob: bytes, key: bytes | str) -> bytes:
    k = _norm_key(key)
    if len(blob) < len(_MAGIC) + 16 + 32 or not blob.startswith(_MAGIC):
        raise ValueError("not a paddle_tpu encrypted blob")
    nonce = blob[len(_MAGIC):len(_MAGIC) + 16]
    ct = blob[len(_MAGIC) + 16:-32]
    mac = blob[-32:]
    want = hmac.new(k, _MAGIC + nonce + ct, hashlib.sha256).digest()
    if not hmac.compare_digest(mac, want):
        raise ValueError("wrong key or tampered file (HMAC mismatch)")
    return _xor(ct, _keystream(k, nonce, len(ct)))


def _to_numpy_tree(obj):
    """``obj`` with every tensor (anything with ``detach`` and ``cpu``: a
    torch tensor) as a numpy array, dicts, lists and tuples kept."""
    import numpy as np

    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy_tree(v) for v in obj)
    if hasattr(obj, "detach") and hasattr(obj, "cpu"):
        return obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        return obj
    return obj


def save_encrypted(obj, path: str, key: bytes | str, protocol: int = 4):
    """Pickle ``obj`` (tensors as numpy) and write it encrypted (reference
    paddle.save with a cipher).
    Plaintext never touches disk: pickling happens in memory."""
    blob = encrypt_bytes(
        pickle.dumps(_to_numpy_tree(obj), protocol=protocol), key)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)
    return path


def load_encrypted(path: str, key: bytes | str):
    """Read and decrypt what :func:`save_encrypted` wrote (reference
    encrypted-model load path);
    decryption and unpickling stay in memory."""
    with open(path, "rb") as f:
        data = decrypt_bytes(f.read(), key)
    return pickle.loads(data)
