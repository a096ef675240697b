"""2D copter rendering (Lander2D/Hover2D/1D views).

Visual-capability twin of the reference 2D renderer
(attic/gym_copter/rendering/twod.py) — same viewport, scale, polygon
geometry (hull, legs, motors, prop blades), colors, ground/sky split,
prop-spin emulation by alternating blade visibility (:124-129), and the
Lander flags with the wind pennant pointing along the sign of the initial
Y-force perturbation (:189-207).

The reference needs Box2D + gym classic_control (OpenGL); this version is
pure matplotlib: `render(pose, spinning)` returns an RGB array (or draws
interactively), `play(poses, spinning)` animates a recorded trajectory —
fed from logged rollouts, never sharing memory with the simulation.
"""

from __future__ import annotations

import numpy as np

VIEWPORT_W, VIEWPORT_H = 600, 400
SCALE = 30.0
GROUND_Z = 3.33
GEAR_HEIGHT = 0.85

HULL_POLY = [(-30, 0), (-4, 4), (4, 4), (30, 0), (4, -14), (-4, -14)]
LEG_X, LEG_Y, LEG_W, LEG_H = 12, -7, 3, 20
MOTOR_X, MOTOR_Y, MOTOR_W, MOTOR_H = 25, 7, 4, 5
BLADE_X, BLADE_Y, BLADE_W, BLADE_H = 25, 8, 20, 2

SKY_COLOR = (0.5, 0.8, 1.0)
GROUND_COLOR = (0.5, 0.7, 0.3)
VEHICLE_COLOR = (1.0, 1.0, 1.0)
MOTOR_COLOR = (0.5, 0.5, 0.5)
PROP_COLOR = (0.0, 0.0, 0.0)
OUTLINE_COLOR = (0.0, 0.0, 0.0)
FLAG_COLOR = (0.8, 0.0, 0.0)


def _leg_poly(x):
    return [(x * LEG_X, LEG_Y), (x * LEG_X + LEG_W, LEG_Y),
            (x * LEG_X + LEG_W, LEG_Y - LEG_H), (x * LEG_X, LEG_Y - LEG_H)]


def _motor_poly(x):
    return [(x * MOTOR_X, MOTOR_Y), (x * MOTOR_X + MOTOR_W, MOTOR_Y),
            (x * MOTOR_X + MOTOR_W, MOTOR_Y - MOTOR_H),
            (x * MOTOR_X, MOTOR_Y - MOTOR_H)]


def _blade_poly(x, w):
    return [(x * BLADE_X, BLADE_Y),
            (x * BLADE_X + w * BLADE_W / 2, BLADE_Y + BLADE_H),
            (x * BLADE_X + w * BLADE_W, BLADE_Y),
            (x * BLADE_X + w * BLADE_W / 2, BLADE_Y - BLADE_H)]


class TwoDRenderer:
    """pose = (x, y, z_ned, phi); 1D mode zeroes the Y component
    (twod.py:95-97)."""

    def __init__(self, one_d=False, show_flags=False, target_radius=2.0,
                 initial_random_x=0.0):
        import matplotlib.pyplot as plt
        self._plt = plt
        self.one_d = one_d
        self.show_flags = show_flags
        self.target_radius = target_radius
        self.initial_random_x = initial_random_x
        self.props_visible = 0

        self.fig, self.ax = plt.subplots(
            figsize=(VIEWPORT_W / 100, VIEWPORT_H / 100), dpi=100)
        self.ax.set_xlim(0, VIEWPORT_W / SCALE)
        self.ax.set_ylim(0, VIEWPORT_H / SCALE)
        self.ax.set_aspect('equal')
        self.ax.axis('off')
        self.fig.subplots_adjust(left=0, right=1, top=1, bottom=0)

        self._polys = ([HULL_POLY, _leg_poly(-1), _leg_poly(1)],
                       [_motor_poly(1), _motor_poly(-1)],
                       [_blade_poly(1, -1), _blade_poly(1, 1),
                        _blade_poly(-1, -1), _blade_poly(-1, 1)])

    def _transform(self, poly, pose):
        x, y, z, phi = pose
        pts = np.asarray(poly, np.float64) / SCALE
        ang = -phi
        rot = np.array([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]])
        pts = pts @ rot.T
        cx = y + VIEWPORT_W / SCALE / 2          # horizontal = Y (twod.py:113)
        cy = -z + GROUND_Z + GEAR_HEIGHT          # vertical = altitude
        return pts + np.array([cx, cy])

    def render(self, pose, spinning=False, rgb_array=True):
        from matplotlib.patches import Polygon

        if self.one_d:
            pose = (pose[0], 0.0, pose[2], 0.0)
        else:
            pose = tuple(pose[:4])
        ax = self.ax
        for artist in list(ax.patches) + list(ax.lines):
            artist.remove()

        w, h = VIEWPORT_W / SCALE, VIEWPORT_H / SCALE
        ax.add_patch(Polygon([(0, 0), (w, 0), (w, h), (0, h)],
                             color=GROUND_COLOR, zorder=0))
        ax.add_patch(Polygon([(0, GROUND_Z), (w, GROUND_Z), (w, h),
                              (0, h)], color=SKY_COLOR, zorder=1))

        def draw(poly, color):
            pts = self._transform(poly, pose)
            ax.add_patch(Polygon(pts, facecolor=color,
                                 edgecolor=OUTLINE_COLOR, linewidth=1,
                                 zorder=3))

        for poly in self._polys[0]:
            draw(poly, VEHICLE_COLOR)
        for poly in self._polys[1]:
            draw(poly, MOTOR_COLOR)
        # prop-spin emulation by alternating visibility (twod.py:124-129)
        if not spinning or self.props_visible:
            for poly in self._polys[2]:
                draw(poly, PROP_COLOR)
        self.props_visible = (not spinning or ((self.props_visible + 1) % 3))

        if self.show_flags:
            for d in (-1, 1):
                fx = d * self.target_radius + w / 2
                y1, y2 = GROUND_Z, GROUND_Z + 50 / SCALE
                ax.plot([fx, fx], [y1, y2], color='white', lw=2, zorder=2)
                if not self.one_d:
                    wind = self.initial_random_x
                    ax.add_patch(Polygon(
                        [(fx, y2), (fx, y2 - 10 / SCALE),
                         (fx + wind * 25 / SCALE, y2 - 5 / SCALE)],
                        color=FLAG_COLOR, zorder=2))

        if rgb_array:
            self.fig.canvas.draw()
            buf = np.frombuffer(self.fig.canvas.buffer_rgba(), np.uint8)
            fw, fh = self.fig.canvas.get_width_height()
            return buf.reshape(fh, fw, 4)[..., :3].copy()
        self._plt.pause(0.001)
        return None

    def play(self, poses, spinning=None, fps=100, outfile=None, show=True,
             stride=2):
        """Animate (T, >=4) poses; optional per-step spinning flags."""
        from matplotlib import animation

        poses = np.asarray(poses)[::stride]
        if spinning is None:
            spinning = np.ones(len(poses), bool)
        else:
            spinning = np.asarray(spinning)[::stride]

        def animate(i):
            self.render(poses[i], bool(spinning[i]), rgb_array=False)
            return []

        anim = animation.FuncAnimation(self.fig, animate, frames=len(poses),
                                       interval=1000 * stride / fps,
                                       blit=False, repeat=False)
        if outfile is not None:
            if animation.FFMpegWriter.isAvailable():
                writer = animation.FFMpegWriter(fps=max(1, fps // stride))
            else:
                if outfile.endswith('.mp4'):
                    outfile = outfile[:-4] + '.gif'
                writer = animation.PillowWriter(fps=max(1, fps // stride))
            anim.save(outfile, writer=writer)
            print('saved', outfile)
        if show:
            self._plt.show()

    def close(self):
        self._plt.close(self.fig)


class TwoDLanderRenderer(TwoDRenderer):
    """Adds the target flags + wind pennants (twod.py:179-207)."""

    def __init__(self, one_d=False, target_radius=2.0, initial_random_x=0.0):
        super().__init__(one_d=one_d, show_flags=True,
                         target_radius=target_radius,
                         initial_random_x=initial_random_x)


class TwoDHoverRenderer(TwoDRenderer):
    def __init__(self, one_d=False):
        super().__init__(one_d=one_d, show_flags=False)
