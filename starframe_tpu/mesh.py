"""2D meshes, skins, and skeletal animation (SURVEY.md §2 row 16).

Starframe's graphics stack imports glTF meshes with skins and samples
skeletal animations on the CPU before uploading to wgpu. The array-program
rebuild keeps assets host-side (numpy) and makes the hot per-frame work —
forward kinematics and linear-blend skinning — a batched JAX computation:
skinning is one ``[V, K]``-weighted gather of bone transforms applied as
fused multiply-adds (vmappable over instances, matrix-unit friendly at scale).

Components:

- :class:`Mesh` — triangle mesh (verts [V, 2], tris [F, 3]).
- :class:`Skeleton` — bone hierarchy with local bind poses; FK via a
  topologically-ordered compose (bones are few; this is host-light).
- :class:`Skin` — per-vertex bone indices/weights [V, K].
- :class:`AnimationClip` / :func:`sample_clip` — keyframed bone-local
  (pos, angle) tracks with linear interpolation (shortest-arc for angles).
- :func:`skin_verts` — linear-blend skinning, jittable.
- :func:`load_gltf` — minimal glTF 2.0 importer (embedded/GLB buffers):
  nodes -> skeleton, mesh POSITION/JOINTS_0/WEIGHTS_0 -> mesh+skin,
  animations (translation + z-rotation) -> clips. 3D inputs are projected
  to the XY plane (rotation about +Z), matching the 2D engine.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import struct
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import math2d as m2


# ---------------------------------------------------------------------------
# assets (host-side numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Mesh:
    verts: np.ndarray  # [V, 2] f32, local space
    tris: np.ndarray  # [F, 3] i32
    uvs: Optional[np.ndarray] = None  # [V, 2]

    @staticmethod
    def from_convex_polygon(verts) -> "Mesh":
        """Fan-triangulate a convex CCW polygon."""
        v = np.asarray(verts, np.float32)
        n = len(v)
        tris = np.array([[0, i, i + 1] for i in range(1, n - 1)], np.int32)
        return Mesh(verts=v, tris=tris)

    @staticmethod
    def quad(hw: float, hh: float) -> "Mesh":
        return Mesh.from_convex_polygon(
            [(-hw, -hh), (hw, -hh), (hw, hh), (-hw, hh)])


@dataclasses.dataclass
class Skeleton:
    """Bone hierarchy. ``parent[b] < b`` (topological order; root = -1)."""

    parent: np.ndarray  # [B] i32
    bind_pos: np.ndarray  # [B, 2] f32 — bone-local bind translation
    bind_angle: np.ndarray  # [B] f32 — bone-local bind rotation
    names: Optional[List[str]] = None

    @property
    def n_bones(self) -> int:
        return len(self.parent)

    def validate(self):
        for b, p in enumerate(self.parent):
            if p >= b:
                raise ValueError("bones must be topologically ordered "
                                 f"(bone {b} has parent {p})")


@dataclasses.dataclass
class Skin:
    joints: np.ndarray  # [V, K] i32 bone indices
    weights: np.ndarray  # [V, K] f32, rows sum to 1
    # inverse bind transforms (world->bone at bind pose), derived or imported
    inv_bind_pos: np.ndarray  # [B, 2]
    inv_bind_angle: np.ndarray  # [B]


@dataclasses.dataclass
class AnimationClip:
    """Per-bone keyframed local pose tracks, shared key times."""

    times: np.ndarray  # [T] f32, strictly increasing
    pos: np.ndarray  # [T, B, 2]
    angle: np.ndarray  # [T, B]
    name: str = "clip"

    @property
    def duration(self) -> float:
        return float(self.times[-1])


# ---------------------------------------------------------------------------
# forward kinematics + skinning (jittable)
# ---------------------------------------------------------------------------


def fk_world_poses(skeleton: Skeleton, local_pos, local_angle):
    """Compose bone-local poses down the hierarchy.

    local_pos [B, 2], local_angle [B] -> (world_pos [B, 2], world_angle [B]).
    Bones are topologically ordered, so a python loop over B composes
    correctly; B is small (tens), so this stays cheap under jit.
    """
    B = skeleton.n_bones
    wp: List = [None] * B
    wa: List = [None] * B
    for b in range(B):
        p = int(skeleton.parent[b])
        if p < 0:
            wp[b] = local_pos[b]
            wa[b] = local_angle[b]
        else:
            wp[b] = wp[p] + m2.rotate(wa[p], local_pos[b])
            wa[b] = wa[p] + local_angle[b]
    return jnp.stack(wp), jnp.stack(wa)


def bind_inverse(skeleton: Skeleton):
    """Inverse bind transforms from the skeleton's bind pose (host)."""
    wp, wa = fk_world_poses(
        skeleton, jnp.asarray(skeleton.bind_pos), jnp.asarray(skeleton.bind_angle))
    wp, wa = np.asarray(wp), np.asarray(wa)
    inv_a = -wa
    c, s = np.cos(inv_a), np.sin(inv_a)
    inv_p = np.stack([-(c * wp[:, 0] - s * wp[:, 1]),
                      -(s * wp[:, 0] + c * wp[:, 1])], -1)
    return inv_p.astype(np.float32), inv_a.astype(np.float32)


def skin_verts(verts, joints, weights, bone_pos, bone_angle,
               inv_bind_pos, inv_bind_angle):
    """Linear-blend skinning (jittable; vmap over instances for batches).

    verts [V, 2]; joints [V, K] i32; weights [V, K]; bone_* [B, ...] world
    bone poses; inv_bind_* [B, ...]. Returns skinned verts [V, 2].
    Each bone's skinning transform is world_pose âˆ˜ inv_bind; the vertex is
    the weight-blended sum of its K bone transforms applied to it.
    """
    # per-bone skinning transform: angle = wa + inv_a; pos = wp + R(wa) inv_p
    ang = bone_angle + inv_bind_angle  # [B]
    pos = bone_pos + m2.rotate(bone_angle, inv_bind_pos)  # [B, 2]
    ca, sa = jnp.cos(ang), jnp.sin(ang)
    # gather per-vertex-influence transforms [V, K, ...]
    cak, sak = ca[joints], sa[joints]
    posk = pos[joints]  # [V, K, 2]
    vx = verts[:, None, 0]
    vy = verts[:, None, 1]
    tx = posk[..., 0] + cak * vx - sak * vy
    ty = posk[..., 1] + sak * vx + cak * vy
    out = jnp.stack([(weights * tx).sum(-1), (weights * ty).sum(-1)], -1)
    return out


def _lerp_angle(a0, a1, t):
    d = (a1 - a0 + jnp.pi) % (2 * jnp.pi) - jnp.pi
    return a0 + d * t


def sample_clip(clip: AnimationClip, t):
    """Sample bone-local poses at time ``t`` (clamped; linear interpolation,
    shortest-arc on angles). Jittable: returns (pos [B, 2], angle [B])."""
    times = jnp.asarray(clip.times)
    pos = jnp.asarray(clip.pos)
    ang = jnp.asarray(clip.angle)
    t = jnp.clip(t, times[0], times[-1])
    i1 = jnp.clip(jnp.searchsorted(times, t, side="right"), 1, len(clip.times) - 1)
    i0 = i1 - 1
    t0, t1 = times[i0], times[i1]
    f = jnp.where(t1 > t0, (t - t0) / jnp.maximum(t1 - t0, 1e-9), 0.0)
    p = pos[i0] + (pos[i1] - pos[i0]) * f
    a = _lerp_angle(ang[i0], ang[i1], f)
    return p, a


class Animator:
    """Plays a clip on a skeleton+skin and produces skinned vertices —
    starframe's ``Animator`` equivalent. ``skinned(t)`` is jittable."""

    def __init__(self, skeleton: Skeleton, skin: Skin, mesh: Mesh,
                 clip: AnimationClip):
        skeleton.validate()
        self.skeleton = skeleton
        self.skin = skin
        self.mesh = mesh
        self.clip = clip
        self._verts = jnp.asarray(mesh.verts)
        self._joints = jnp.asarray(skin.joints)
        self._weights = jnp.asarray(skin.weights)
        self._ibp = jnp.asarray(skin.inv_bind_pos)
        self._iba = jnp.asarray(skin.inv_bind_angle)

    def skinned(self, t):
        lp, la = sample_clip(self.clip, t)
        wp, wa = fk_world_poses(self.skeleton, lp, la)
        return skin_verts(self._verts, self._joints, self._weights,
                          wp, wa, self._ibp, self._iba)


# ---------------------------------------------------------------------------
# minimal glTF 2.0 import (embedded base64 or GLB binary chunks)
# ---------------------------------------------------------------------------

_COMP = {5120: ("b", 1), 5121: ("B", 1), 5122: ("h", 2), 5123: ("H", 2),
         5125: ("I", 4), 5126: ("f", 4)}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _read_buffers(g: dict, blob: Optional[bytes]) -> List[bytes]:
    out = []
    for buf in g.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(blob)
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            raise ValueError("external glTF buffers are not supported "
                             "(embed them: data: URIs or GLB)")
    return out


def _accessor(g: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = g["accessors"][idx]
    view = g["bufferViews"][acc["bufferView"]]
    fmt, size = _COMP[acc["componentType"]]
    n = _NCOMP[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", size * n)
    raw = buffers[view.get("buffer", 0)]
    rows = []
    for i in range(count):
        o = offset + i * stride
        rows.append(struct.unpack_from("<" + fmt * n, raw, o))
    a = np.asarray(rows)
    if acc.get("normalized") and fmt in ("B", "H"):
        a = a / float({"B": 255, "H": 65535}[fmt])
    return a


def _quat_to_z_angle(q) -> float:
    x, y, z, w = q
    return float(np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z)))


def load_gltf(path_or_bytes) -> dict:
    """Load a (minimal) glTF 2.0 asset: returns a dict with ``meshes``
    (Mesh), ``skeleton`` (Skeleton or None), ``skin`` (Skin or None) and
    ``clips`` ({name: AnimationClip}). 3D data is projected onto XY with
    rotations about +Z — the 2D engine's plane."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            data = fh.read()
    blob = None
    if data[:4] == b"glTF":  # GLB container
        _, _, _ = struct.unpack_from("<III", data, 0)
        off = 12
        g = None
        while off < len(data):
            clen, ctype = struct.unpack_from("<II", data, off)
            chunk = data[off + 8: off + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                g = json.loads(chunk)
            elif ctype == 0x004E4942:  # BIN
                blob = chunk
            off += 8 + clen
        assert g is not None, "GLB without JSON chunk"
    else:
        g = json.loads(data)
    buffers = _read_buffers(g, blob)

    meshes = []
    skin_data = None
    for mesh in g.get("meshes", []):
        prim = mesh["primitives"][0]
        pos = _accessor(g, buffers, prim["attributes"]["POSITION"])[:, :2]
        tris = _accessor(g, buffers, prim["indices"]).reshape(-1, 3).astype(np.int32) \
            if "indices" in prim else \
            np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
        uvs = None
        if "TEXCOORD_0" in prim["attributes"]:
            uvs = _accessor(g, buffers, prim["attributes"]["TEXCOORD_0"])[:, :2]
        meshes.append(Mesh(verts=pos.astype(np.float32), tris=tris, uvs=uvs))
        if "JOINTS_0" in prim["attributes"]:
            skin_data = (
                _accessor(g, buffers, prim["attributes"]["JOINTS_0"]).astype(np.int32),
                _accessor(g, buffers, prim["attributes"]["WEIGHTS_0"]).astype(np.float32),
            )

    skeleton = None
    skin = None
    node_to_bone: Dict[int, int] = {}
    if g.get("skins"):
        sk = g["skins"][0]
        joints_nodes = sk["joints"]
        # order bones topologically (parents before children)
        parent_of = {}
        for ni, node in enumerate(g.get("nodes", [])):
            for ch in node.get("children", []):
                parent_of[ch] = ni
        order: List[int] = []

        def add(ni):
            if ni in order:
                return
            p = parent_of.get(ni)
            if p is not None and p in joints_nodes:
                add(p)
            order.append(ni)

        for ni in joints_nodes:
            add(ni)
        node_to_bone = {ni: b for b, ni in enumerate(order)}
        B = len(order)
        parent = np.full(B, -1, np.int32)
        bind_pos = np.zeros((B, 2), np.float32)
        bind_angle = np.zeros(B, np.float32)
        names = []
        for ni in order:
            b = node_to_bone[ni]
            node = g["nodes"][ni]
            p = parent_of.get(ni)
            parent[b] = node_to_bone.get(p, -1) if p is not None else -1
            tr = node.get("translation", [0, 0, 0])
            bind_pos[b] = tr[:2]
            bind_angle[b] = _quat_to_z_angle(node.get("rotation", [0, 0, 0, 1]))
            names.append(node.get("name", f"bone{b}"))
        skeleton = Skeleton(parent=parent, bind_pos=bind_pos,
                            bind_angle=bind_angle, names=names)
        if skin_data is not None:
            joints_raw, weights = skin_data
            # remap skin joint indices (into sk["joints"]) to bone order
            remap = np.array([node_to_bone[joints_nodes[j]]
                              for j in range(len(joints_nodes))], np.int32)
            joints = remap[joints_raw]
            wsum = weights.sum(-1, keepdims=True)
            weights = weights / np.maximum(wsum, 1e-9)
            ibp, iba = bind_inverse(skeleton)
            skin = Skin(joints=joints, weights=weights,
                        inv_bind_pos=ibp, inv_bind_angle=iba)

    clips: Dict[str, AnimationClip] = {}
    for ai, anim in enumerate(g.get("animations", [])):
        if skeleton is None:
            break
        B = skeleton.n_bones
        # gather all key times
        all_t = sorted({float(t) for ch in anim["channels"]
                        for t in _accessor(
                            g, buffers,
                            anim["samplers"][ch["sampler"]]["input"])[:, 0]})
        times = np.asarray(all_t, np.float32)
        pos = np.tile(skeleton.bind_pos[None], (len(times), 1, 1))
        ang = np.tile(skeleton.bind_angle[None], (len(times), 1))
        for ch in anim["channels"]:
            tgt = ch["target"]
            ni = tgt["node"]
            if ni not in node_to_bone:
                continue
            b = node_to_bone[ni]
            samp = anim["samplers"][ch["sampler"]]
            kt = _accessor(g, buffers, samp["input"])[:, 0]
            kv = _accessor(g, buffers, samp["output"])
            for fi, t in enumerate(times):
                j = int(np.clip(np.searchsorted(kt, t, side="right"), 1, len(kt) - 1))
                f = 0.0 if kt[j] == kt[j - 1] else (t - kt[j - 1]) / (kt[j] - kt[j - 1])
                f = float(np.clip(f, 0.0, 1.0))
                if tgt["path"] == "translation":
                    v = kv[j - 1] * (1 - f) + kv[j] * f
                    pos[fi, b] = v[:2]
                elif tgt["path"] == "rotation":
                    a0 = _quat_to_z_angle(kv[j - 1])
                    a1 = _quat_to_z_angle(kv[j])
                    d = (a1 - a0 + np.pi) % (2 * np.pi) - np.pi
                    ang[fi, b] = a0 + d * f
        clips[anim.get("name", f"clip{ai}")] = AnimationClip(
            times=times, pos=pos, angle=ang, name=anim.get("name", f"clip{ai}"))

    return dict(meshes=meshes, skeleton=skeleton, skin=skin, clips=clips)
