"""Heads-up display: artificial horizon with instrument tapes.

Capability twin of the reference pyglet HUD
(attic/gym_copter/rendering/hud.py:179-355): sky/ground horizon rotated by
roll and shifted by pitch, a pitch ladder, a roll arc with pointer, a
heading tape across the top, vertical altitude and ground-speed tapes, and
a time display — reimplemented in matplotlib (no pyglet/OpenGL needed) and
fed from recorded state, never from a live sim thread.

`render(state, t)` takes the 12-dim state vector and returns an RGB array.
"""

from __future__ import annotations

import numpy as np

W, H = 800, 500


class HUD:

    def __init__(self):
        import matplotlib.pyplot as plt
        self._plt = plt
        self.fig, self.ax = plt.subplots(figsize=(W / 100, H / 100), dpi=100)
        self.fig.subplots_adjust(left=0, right=1, top=1, bottom=0)

    def render(self, state, t=0.0, rgb_array=True):
        import matplotlib.patches as mp

        x, dx, y, dy, z, dz, phi, dphi, theta, dtheta, psi, dpsi = state
        altitude = -z
        groundspeed = float(np.hypot(dx, dy))
        heading = float(np.degrees(psi)) % 360

        ax = self.ax
        ax.clear()
        ax.set_xlim(-4, 4)
        ax.set_ylim(-2.5, 2.5)
        ax.axis('off')

        # --- horizon: rotate by roll, shift by pitch (hud.py pitch/roll
        # reticle) ---
        pitch_off = np.degrees(theta) / 20.0
        cph, sph = np.cos(-phi), np.sin(-phi)
        big = 20.0

        def rot(px, py):
            py = py + pitch_off
            return (px * cph - py * sph, px * sph + py * cph)

        sky = [rot(-big, 0), rot(big, 0), rot(big, big), rot(-big, big)]
        gnd = [rot(-big, 0), rot(big, 0), rot(big, -big), rot(-big, -big)]
        ax.add_patch(mp.Polygon(gnd, color=(0.5, 0.7, 0.3), zorder=0))
        ax.add_patch(mp.Polygon(sky, color=(0.5, 0.8, 1.0), zorder=1))

        # pitch ladder every 10 degrees
        for deg in range(-30, 40, 10):
            w_ = 0.8 if deg == 0 else 0.4
            yy = deg / 20.0
            p1, p2 = rot(-w_, yy), rot(w_, yy)
            ax.plot([p1[0], p2[0]], [p1[1], p2[1]], color='white', lw=1.5,
                    zorder=2)
            if deg != 0:
                lp = rot(w_ + 0.25, yy)
                ax.text(lp[0], lp[1], f'{deg}', color='white', fontsize=7,
                        ha='center', va='center', zorder=3)

        # center reticle
        ax.plot([-0.5, -0.15], [0, 0], color='yellow', lw=2, zorder=4)
        ax.plot([0.15, 0.5], [0, 0], color='yellow', lw=2, zorder=4)
        ax.plot([0], [0], marker='o', color='yellow', markersize=3, zorder=4)

        # --- roll arc + pointer (hud.py roll arc) ---
        arc_r = 1.8
        angs = np.radians(np.arange(-60, 61, 10))
        for a in angs:
            r0, r1 = arc_r, arc_r + (0.12 if np.degrees(a) % 30 == 0 else 0.07)
            ax.plot([r0 * np.sin(a), r1 * np.sin(a)],
                    [r0 * np.cos(a), r1 * np.cos(a)], color='white', lw=1,
                    zorder=3)
        pa = -phi
        ax.add_patch(mp.Polygon(
            [(arc_r * 0.95 * np.sin(pa), arc_r * 0.95 * np.cos(pa)),
             ((arc_r - 0.15) * np.sin(pa + 0.03),
              (arc_r - 0.15) * np.cos(pa + 0.03)),
             ((arc_r - 0.15) * np.sin(pa - 0.03),
              (arc_r - 0.15) * np.cos(pa - 0.03))],
            color='yellow', zorder=4))

        # --- heading tape (top) ---
        ax.add_patch(mp.Rectangle((-4, 2.1), 8, 0.4, color='black',
                                  alpha=0.55, zorder=5))
        for hdg in range(-50, 60, 10):
            mark = (heading + hdg) % 360
            px = hdg / 12.5
            ax.plot([px, px], [2.12, 2.2], color='white', lw=1, zorder=6)
            if hdg % 30 == 0:
                ax.text(px, 2.32, f'{int(mark):03d}', color='white',
                        fontsize=7, ha='center', zorder=6)
        ax.plot([0, 0], [2.1, 2.02], color='yellow', lw=2, zorder=6)

        # --- altitude tape (right) and ground-speed tape (left) ---
        for side, label, value in ((3.4, 'ALT', altitude),
                                   (-3.4, 'SPD', groundspeed)):
            ax.add_patch(mp.Rectangle((side - 0.4, -1.8), 0.8, 3.6,
                                      color='black', alpha=0.55, zorder=5))
            for dv in range(-4, 5):
                v = value + dv
                py = dv * 0.42
                ax.plot([side - 0.38, side - 0.25], [py, py], color='white',
                        lw=1, zorder=6)
                ax.text(side + 0.05, py, f'{v:5.1f}', color='white',
                        fontsize=7, ha='center', va='center', zorder=6)
            ax.add_patch(mp.Rectangle((side - 0.42, -0.14), 0.84, 0.28,
                                      fill=False, edgecolor='yellow', lw=1.5,
                                      zorder=7))
            ax.text(side, 2.0, label, color='white', fontsize=8, ha='center',
                    zorder=6)

        # --- time display (hud.py time display) ---
        ax.text(0, -2.3, f't = {t:6.2f} s', color='white', fontsize=9,
                ha='center', zorder=6,
                bbox=dict(facecolor='black', alpha=0.55, edgecolor='none'))

        if rgb_array:
            self.fig.canvas.draw()
            buf = np.frombuffer(self.fig.canvas.buffer_rgba(), np.uint8)
            fw, fh = self.fig.canvas.get_width_height()
            return buf.reshape(fh, fw, 4)[..., :3].copy()
        self._plt.pause(0.001)
        return None

    def close(self):
        self._plt.close(self.fig)
