"""Synthetic downward-looking vision and DVS (event-camera) sensors on
torch tensors: the counterpart of `gym_copter_tpu/sensors/vision.py`.

The geometry is the JAX module's (after the reference's attic/gym_copter/
sensors/vision/vs.py and dvs.py): pin-hole scaling by altitude, truncated
(vs.py:109-115); the P*T*Rtheta*Rpsi*Rphi projective chain collapsed to a
closed-form 3x3 homography (vs.py:117-199); its adjugate as the inverse;
the filled landing-pad circle evaluated at each output pixel's
inverse-mapped source coordinate over the cropped warp frame (vs.py:59-65);
DVS as the sign of the first difference of consecutive frames
(dvs.py:37-52).  Every operation is elementwise over a leading batch: no
linear algebra, no host copy, so a step of env plus camera can be captured
in a CUDA graph.  Every division is by a tensor, never by a Python scalar
(see core/device.div).

Images are (res, res) for one pose, (B, res, res) batched, float32.
"""

from __future__ import annotations

import math

import torch

from gym_copter_tpu_torch.core.device import resolve_device

RAD_PER_DEG = math.pi / 180  # rounded to float32 where it multiplies
DEG_PER_RAD = 180 / math.pi  # float32, as jnp.radians/degrees round them


def _adjugate3(m):
    """Adjugate of a 3x3 matrix given as nested lists of tensors: inv(m) *
    det(m), elementwise cofactors."""
    (a, b, c), (d, e, f), (g, h, i) = m
    return [[e * i - f * h, c * h - b * i, b * f - c * e],
            [f * g - d * i, a * i - c * g, c * d - a * f],
            [d * h - e * g, b * g - a * h, a * e - b * d]]


class VisionSensor:
    """Downward camera over the landing pad.  Python-number poses render
    on `device` (the card unless the caller names another); tensor poses
    on their own device."""

    def __init__(self, objsize: float = 1.0, res: int = 128,
                 fov: float = 60.0, device=None):
        self.objsize = objsize
        self.res = res
        self.fov = fov
        self.device = resolve_device(device)

        # static warp-frame geometry (vs.py:50-53, 126-131)
        d = math.hypot(res, res)
        half_fov = math.radians(fov / 2)
        self.side_length = int(d / math.cos(half_fov))
        self.side_length_f = d / math.cos(half_fov)
        self.h = d / (2.0 * math.sin(half_fov))
        self.n = self.h - d / 2.0
        self.f = self.h + d / 2.0
        self.margin = (self.side_length - res) // 2
        self._grids = {}

    # -- homography ---------------------------------------------------------

    def _warp_homography(self, psi, theta, phi):
        """3x3 output<-input pixel homography, normalized to H[2,2] = 1, as
        nested lists of float32 tensors of the angles' shape.  Angles in
        degrees.  The closed form of the JAX module (its docstring derives
        it): with R = Rtheta @ Rpsi @ Rphi, k = 1/tan(fov/2) and s the warp
        frame's side, rows over centred (x, y, 1) are
        u' = (s/2)((k R00 - R20) x + (k R01 - R21) y + h),
        v' = (s/2)((k R10 - R20) x + (k R11 - R21) y + h),
        w' = -R20 x - R21 y + h, composed with the corner shift."""
        st, ct = torch.sin(psi * RAD_PER_DEG), torch.cos(psi * RAD_PER_DEG)
        sp, cp = (torch.sin(theta * RAD_PER_DEG),
                  torch.cos(theta * RAD_PER_DEG))
        sg, cg = torch.sin(phi * RAD_PER_DEG), torch.cos(phi * RAD_PER_DEG)

        # needed entries of R = r_theta @ r_psi @ r_phi (z=0 kills col 2)
        r00 = ct * cg
        r01 = -st
        r10 = cp * st * cg - sp * sg
        r11 = cp * ct
        r20 = sp * st * cg + cp * sg
        r21 = sp * ct

        half_fov = math.radians(self.fov / 2)
        k = 1.0 / math.tan(half_fov)
        s2 = self.side_length_f * 0.5
        h = self.h
        hw = self.res / 2.0

        a0 = s2 * (k * r00 - r20)
        a1 = s2 * (k * r01 - r21)
        a2 = torch.full_like(st, s2 * h)
        b0 = s2 * (k * r10 - r20)
        b1 = s2 * (k * r11 - r21)
        b2 = a2
        c0 = -r20
        c1 = -r21
        c2 = torch.full_like(st, h)

        det = c2 - hw * c0 - hw * c1
        rows = [[a0, a1, a2 - hw * a0 - hw * a1],
                [b0, b1, b2 - hw * b0 - hw * b1],
                [c0, c1, det]]
        return [[m / det for m in row] for row in rows]

    # -- rendering ----------------------------------------------------------

    def _scale(self, z, val):
        """Altitude-scaled pin-hole projection, truncated to int like the
        reference (vs.py:109-115)."""
        half_fov = math.radians(self.fov / 2)
        return torch.trunc(val * self.res
                           / (2.0 * z * math.tan(half_fov)))

    def _grid(self, device):
        """(rows, cols) of the cropped warp region, float32 (res, res),
        made once per device: a graph capture cannot copy from the host."""
        if device not in self._grids:
            idx = torch.arange(self.res, dtype=torch.float32, device=device)
            rows = (idx[:, None] + self.margin).expand(self.res, self.res)
            self._grids[device] = (rows.contiguous(), rows.T.contiguous())
        return self._grids[device]

    def _render(self, x, y, z, phi, theta, psi):
        """Float32 tensors of one shape S -> images S + (res, res)."""
        cx = self._scale(z, x) + self.res // 2
        cy = self._scale(z, y) + self.res // 2
        r = self._scale(z, torch.full_like(z, self.objsize))

        # adjugate inverse: hinv is only used through the projective ratios
        # u = row0.p / row2.p, so the 1/det scale cancels
        hinv = _adjugate3(self._warp_homography(psi, theta, phi))
        hinv = [[m[..., None, None] for m in row] for row in hinv]
        rows, cols = self._grid(z.device)
        w = hinv[2][0] * cols + hinv[2][1] * rows + hinv[2][2]
        u = (hinv[0][0] * cols + hinv[0][1] * rows + hinv[0][2]) / w
        v = (hinv[1][0] * cols + hinv[1][1] * rows + hinv[1][2]) / w

        # the filled-circle predicate at the source coordinate
        du = u - cx[..., None, None]
        dv = v - cy[..., None, None]
        rr = r * r
        inside = (du * du + dv * dv) <= rr[..., None, None]
        in_bounds = ((u >= 0) & (u <= self.res - 1)
                     & (v >= 0) & (v <= self.res - 1))
        return (inside & in_bounds).to(torch.float32)

    def _f32(self, v, device):
        return torch.as_tensor(v, device=device).to(torch.float32)

    def get_image(self, x, y, z, phi, theta, psi):
        """Render one pose -> (res, res) binary image.  Angles in DEGREES,
        z is positive altitude (the callers negate NED z, e.g.
        attic/gym_copter/envs/lander.py:118)."""
        args = (x, y, z, phi, theta, psi)
        device = next((a.device for a in args if torch.is_tensor(a)),
                      self.device)
        return self._render(*(self._f32(a, device) for a in args))

    def get_images(self, poses):
        """Batched render: poses (6, B) rows (x, y, z, phi, theta, psi),
        angles in degrees, z positive altitude -> (B, res, res)."""
        poses = poses.to(torch.float32)
        return self._render(*poses)

    def pose_from_state(self, x):
        """(12, B) NED state -> (6, B) sensor pose: positive altitude
        clamped away from zero, angles to degrees (the wrappers'
        max(-z, 1e-6) + degrees() convention, hover3d.py:69-76)."""
        alt = torch.clamp(-x[4], min=1e-6)
        return torch.stack([x[0], x[2], alt, x[6] * DEG_PER_RAD,
                            x[8] * DEG_PER_RAD, x[10] * DEG_PER_RAD])


class DVS(VisionSensor):
    """Event camera: sign of the first difference of consecutive frames
    (dvs.py:37-52).  Functional: thread `prev` through the rollout."""

    def initial_prev(self, batch=None, device=None):
        shape = ((self.res, self.res) if batch is None
                 else (batch, self.res, self.res))
        return torch.zeros(shape, dtype=torch.float32,
                           device=device or self.device)

    def get_events(self, prev, x, y, z, phi, theta, psi):
        """Returns (events in {-1,0,+1}, new_prev)."""
        curr = self.get_image(x, y, z, phi, theta, psi)
        return torch.sign(prev - curr), curr

    def get_events_batch(self, prev, poses):
        curr = self.get_images(poses)
        return torch.sign(prev - curr), curr
