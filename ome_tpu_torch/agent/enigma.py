"""Enigma — encrypted model distribution.

Re-designs internal/ome-agent/enigma (enigma.go:19-40: model weight
decryption backed by OCI KMS / Vault secrets): envelope encryption for
model directories. A per-model data key encrypts file contents with
AES-256-GCM in framed chunks; the data key itself is wrapped by a KMS
provider. Providers: LocalKMS (keyfile — dev/test and air-gapped
clusters) and the KMSProvider interface cloud backends implement
(wrap/unwrap only — the data path never talks to the cloud).

Port of ome_tpu/agent/enigma.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import abc
import hashlib
import json
import os
import secrets
import struct
from typing import Optional

from cryptography.hazmat.primitives.ciphers.aead import AESGCM

MAGIC = b"OMEENC1\n"
CHUNK = 4 << 20  # plaintext bytes per GCM frame
ENC_SUFFIX = ".enc"


class EnigmaError(Exception):
    pass


class KMSProvider(abc.ABC):
    """Wraps/unwraps data keys (the only cloud-touching surface)."""

    @abc.abstractmethod
    def wrap_key(self, plaintext_key: bytes) -> bytes:
        ...

    @abc.abstractmethod
    def unwrap_key(self, wrapped_key: bytes) -> bytes:
        ...

    @property
    @abc.abstractmethod
    def key_id(self) -> str:
        ...


class LocalKMS(KMSProvider):
    """Keyfile-backed KMS: wraps data keys with a master AES-GCM key."""

    def __init__(self, keyfile: str, create: bool = False):
        if create and not os.path.exists(keyfile):
            os.makedirs(os.path.dirname(keyfile) or ".", exist_ok=True)
            fd = os.open(keyfile, os.O_WRONLY | os.O_CREAT | os.O_EXCL,
                         0o600)
            with os.fdopen(fd, "wb") as f:
                f.write(secrets.token_bytes(32))
        with open(keyfile, "rb") as f:
            self._master = f.read()
        if len(self._master) != 32:
            raise EnigmaError(f"{keyfile}: master key must be 32 bytes")
        self._key_id = f"local:{os.path.abspath(keyfile)}"

    @property
    def key_id(self) -> str:
        return self._key_id

    def wrap_key(self, plaintext_key: bytes) -> bytes:
        nonce = secrets.token_bytes(12)
        return nonce + AESGCM(self._master).encrypt(nonce, plaintext_key,
                                                    b"ome-data-key")

    def unwrap_key(self, wrapped_key: bytes) -> bytes:
        nonce, ct = wrapped_key[:12], wrapped_key[12:]
        try:
            return AESGCM(self._master).decrypt(nonce, ct, b"ome-data-key")
        except Exception as e:
            raise EnigmaError(f"data key unwrap failed: {e}") from e


def encrypt_file(src: str, dst: str, data_key: bytes,
                 kms: KMSProvider) -> None:
    """MAGIC + header(json) + frames of [len u32][nonce 12][ciphertext]."""
    header = json.dumps({
        "v": 1, "alg": "aes-256-gcm", "chunk": CHUNK,
        "key_id": kms.key_id,
        "wrapped_key": kms.wrap_key(data_key).hex(),
        "orig_name": os.path.basename(src),
        "orig_size": os.path.getsize(src),
    }).encode()
    aes = AESGCM(data_key)
    # every frame's AAD binds the (plaintext) header — orig_name,
    # orig_size, wrapped key — so header tampering, cross-file frame
    # splicing and truncation-with-resize all fail authentication
    aad_base = hashlib.sha256(header).digest()
    tmp = dst + ".part"
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    with open(src, "rb") as fin, open(tmp, "wb") as fout:
        fout.write(MAGIC)
        fout.write(struct.pack("<I", len(header)))
        fout.write(header)
        seq = 0
        while True:
            block = fin.read(CHUNK)
            if not block:
                break
            nonce = secrets.token_bytes(12)
            ct = aes.encrypt(nonce, block,
                             aad_base + struct.pack("<Q", seq))
            fout.write(struct.pack("<I", len(ct)) + nonce + ct)
            seq += 1
    os.replace(tmp, dst)


def decrypt_file(src: str, dst: str, kms: KMSProvider) -> None:
    with open(src, "rb") as fin:
        if fin.read(len(MAGIC)) != MAGIC:
            raise EnigmaError(f"{src}: not an enigma file")
        (hlen,) = struct.unpack("<I", fin.read(4))
        header_raw = fin.read(hlen)
        header = json.loads(header_raw)
        aad_base = hashlib.sha256(header_raw).digest()
        data_key = kms.unwrap_key(bytes.fromhex(header["wrapped_key"]))
        aes = AESGCM(data_key)
        tmp = dst + ".part"
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        with open(tmp, "wb") as fout:
            seq = 0
            while True:
                raw = fin.read(4)
                if not raw:
                    break
                (clen,) = struct.unpack("<I", raw)
                nonce = fin.read(12)
                ct = fin.read(clen)
                try:
                    fout.write(aes.decrypt(
                        nonce, ct, aad_base + struct.pack("<Q", seq)))
                except Exception as e:
                    raise EnigmaError(
                        f"{src}: frame {seq} auth failed: {e}") from e
                seq += 1
        if os.path.getsize(tmp) != header["orig_size"]:
            raise EnigmaError(f"{src}: size mismatch after decrypt")
        os.replace(tmp, dst)


def encrypt_dir(src_dir: str, dst_dir: str, kms: KMSProvider,
                data_key: Optional[bytes] = None) -> int:
    """Encrypt every file; returns count. One data key per model dir."""
    data_key = data_key or secrets.token_bytes(32)
    n = 0
    for root, _, files in os.walk(src_dir):
        for fn in files:
            src = os.path.join(root, fn)
            rel = os.path.relpath(src, src_dir)
            encrypt_file(src, os.path.join(dst_dir, rel + ENC_SUFFIX),
                         data_key, kms)
            n += 1
    return n


def decrypt_dir(src_dir: str, dst_dir: str, kms: KMSProvider) -> int:
    n = 0
    for root, _, files in os.walk(src_dir):
        for fn in files:
            if not fn.endswith(ENC_SUFFIX):
                continue
            src = os.path.join(root, fn)
            rel = os.path.relpath(src, src_dir)[:-len(ENC_SUFFIX)]
            decrypt_file(src, os.path.join(dst_dir, rel), kms)
            n += 1
    return n
