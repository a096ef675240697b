"""Matplotlib 3D visualization, decoupled from simulation.

Capability parity with the reference renderer (gym_copter/rendering/
__init__.py: wireframe quad with four arms and prop circles rotated by the
Euler pose, optional trajectory trace, landing-target circle, view angles,
mp4 export, RGB frame grab) — but architected TPU-natively: the reference
steps the sim on a daemon thread and has the matplotlib timer read shared
mutable `env.pose` without synchronization (rendering/__init__.py:149,
237-240); here rendering *replays a recorded trajectory* pulled off-device
once, so the hot loop never blocks on a GUI and the data race disappears
(SURVEY.md §5 "Race detection").

Poses are (T, 6) arrays: (x, y, z_ned, phi, theta, psi).
"""

from __future__ import annotations

import numpy as np


def _euler_rotation(phi, theta, psi):
    """Body->world rotation matrix from Euler angles (ZYX convention,
    matching the reference's kwon3d-eq.2 vehicle rotation,
    rendering/__init__.py:113-128)."""
    cph, sph = np.cos(phi), np.sin(phi)
    cth, sth = np.cos(theta), np.sin(theta)
    cps, sps = np.cos(psi), np.sin(psi)
    return np.array([
        [cps * cth, cps * sth * sph - sps * cph, cps * sth * cph + sps * sph],
        [sps * cth, sps * sth * sph + cps * cph, sps * sth * cph - cps * sph],
        [-sth, cth * sph, cth * cph],
    ])


class VehicleArtist:
    """Wireframe quad-X: four arms plus four propeller circles."""

    ARM_LENGTH = 0.6
    PROP_RADIUS = 0.3
    PROP_POINTS = 16

    def __init__(self, ax, show_trace=False, color='b'):
        self.show_trace = show_trace
        self.arm_lines = [ax.plot([], [], [], '-', color=color, lw=2)[0]
                          for _ in range(4)]
        self.prop_lines = [ax.plot([], [], [], '-', color=color, lw=1)[0]
                           for _ in range(4)]
        self.trace_line = ax.plot([], [], [], ':', color='gray', lw=1)[0]
        self.trace = []

        # body-frame geometry: arms at 45-degree X, props at arm tips
        d = self.ARM_LENGTH
        self.arm_ends = np.array([[d, d, 0], [-d, -d, 0],
                                  [-d, d, 0], [d, -d, 0]])
        ang = np.linspace(0, 2 * np.pi, self.PROP_POINTS)
        circle = np.stack([self.PROP_RADIUS * np.cos(ang),
                           self.PROP_RADIUS * np.sin(ang),
                           np.zeros_like(ang)], axis=1)
        self.prop_circles = [tip + circle for tip in self.arm_ends]

    def update(self, pose):
        x, y, z, phi, theta, psi = pose
        # NED -> display (z up)
        center = np.array([x, y, -z])
        R = _euler_rotation(phi, theta, psi)
        for line, end in zip(self.arm_lines, self.arm_ends):
            pts = np.stack([center, center + R @ end])
            line.set_data(pts[:, 0], pts[:, 1])
            line.set_3d_properties(pts[:, 2])
        for line, circle in zip(self.prop_lines, self.prop_circles):
            pts = center + circle @ R.T
            line.set_data(pts[:, 0], pts[:, 1])
            line.set_3d_properties(pts[:, 2])
        if self.show_trace:
            self.trace.append(center)
            tr = np.array(self.trace)
            self.trace_line.set_data(tr[:, 0], tr[:, 1])
            self.trace_line.set_3d_properties(tr[:, 2])


class ThreeDRenderer:
    """Replay a (T, 6) pose trajectory in a 3D matplotlib animation."""

    def __init__(self, title='gym-copter-tpu', viewangles=(30, 120),
                 bounds=10.0, altitude=10.0, show_trace=False,
                 fmt='%(title)s'):
        import matplotlib
        import matplotlib.pyplot as plt  # noqa: F401
        self._plt = plt
        self.fig = plt.figure(figsize=(7, 7))
        self.ax = self.fig.add_subplot(111, projection='3d')
        self.ax.set_xlim(-bounds, bounds)
        self.ax.set_ylim(-bounds, bounds)
        self.ax.set_zlim(0, altitude * 1.2)
        self.ax.set_xlabel('X (m)')
        self.ax.set_ylabel('Y (m)')
        self.ax.set_zlabel('Altitude (m)')
        self.ax.set_title(title)
        self.ax.view_init(*viewangles)
        self.vehicle = VehicleArtist(self.ax, show_trace=show_trace)
        self._anim = None

    def decorate(self):
        """Hook for subclasses to add scene geometry."""

    def play(self, poses, fps=100, outfile=None, show=True, stride=2):
        """Animate the trajectory; write MP4 if outfile is given (ffmpeg,
        mirroring the reference's movie export, rendering/__init__.py:
        174-213); display interactively if show."""
        from matplotlib import animation

        poses = np.asarray(poses)[::stride]
        self.decorate()

        def animate(i):
            self.vehicle.update(poses[min(i, len(poses) - 1)])
            return []

        self._anim = animation.FuncAnimation(
            self.fig, animate, frames=len(poses),
            interval=1000 * stride / fps, blit=False, repeat=False)

        if outfile is not None:
            if animation.FFMpegWriter.isAvailable():
                writer = animation.FFMpegWriter(fps=max(1, fps // stride))
            else:
                # no ffmpeg binary in this environment: fall back to a GIF
                if outfile.endswith('.mp4'):
                    outfile = outfile[:-4] + '.gif'
                writer = animation.PillowWriter(fps=max(1, fps // stride))
            self._anim.save(outfile, writer=writer)
            print('saved', outfile)
        if show:
            self._plt.show()

    def frame(self, pose):
        """Render one pose and return it as an RGB array (the reference's
        rgb_array mode, rendering/__init__.py:246-254)."""
        self.decorate()
        self.vehicle.update(pose)
        self.fig.canvas.draw()
        buf = np.frombuffer(self.fig.canvas.buffer_rgba(), dtype=np.uint8)
        w, h = self.fig.canvas.get_width_height()
        return buf.reshape(h, w, 4)[..., :3].copy()

    def close(self):
        self._plt.close(self.fig)


class ThreeDLanderRenderer(ThreeDRenderer):
    """Adds the gray circular landing target of radius TARGET_RADIUS
    (reference rendering/__init__.py:276-312)."""

    def __init__(self, target_radius=2.0, **kwargs):
        super().__init__(title='Lander', **kwargs)
        self.target_radius = target_radius

    def decorate(self):
        ang = np.linspace(0, 2 * np.pi, 64)
        self.ax.plot(self.target_radius * np.cos(ang),
                     self.target_radius * np.sin(ang),
                     np.zeros_like(ang), '-', color='gray', lw=2)


class ThreeDHoverRenderer(ThreeDRenderer):
    """Hover scene (reference rendering/__init__.py:315-328)."""

    def __init__(self, **kwargs):
        super().__init__(title='Hover', **kwargs)


class ThreeDTargetRenderer(ThreeDRenderer):
    """Dual-vehicle view for the Target task: the chaser copter plus a
    second artist tracking the circling target (the reference's
    `ThreeDTarget`, attic/gym_copter/envs/rendering/threed_target.py:11-24,
    which instantiates a second _Vehicle with showtraj=True)."""

    def __init__(self, **kwargs):
        super().__init__(title='Target', **kwargs)
        self.target = VehicleArtist(self.ax, show_trace=True,
                                    color='orange')

    def play_pair(self, poses, target_xyz, fps=100, outfile=None, show=True,
                  stride=2):
        """Animate chaser poses (T, 6) alongside target positions (T, 3)
        (level attitude — the reference renders the target as a second
        vehicle fed from the env's target track)."""
        from matplotlib import animation

        poses = np.asarray(poses)[::stride]
        txyz = np.asarray(target_xyz)[::stride]
        self.decorate()

        def animate(i):
            j = min(i, len(poses) - 1)
            self.vehicle.update(poses[j])
            self.target.update(np.concatenate([txyz[j], np.zeros(3)]))
            return []

        self._anim = animation.FuncAnimation(
            self.fig, animate, frames=len(poses),
            interval=1000 * stride / fps, blit=False, repeat=False)
        if outfile is not None:
            if animation.FFMpegWriter.isAvailable():
                writer = animation.FFMpegWriter(fps=max(1, fps // stride))
            else:
                if outfile.endswith('.mp4'):
                    outfile = outfile[:-4] + '.gif'
                writer = animation.PillowWriter(fps=max(1, fps // stride))
            self._anim.save(outfile, writer=writer)
            print('saved', outfile)
        if show:
            self._plt.show()
