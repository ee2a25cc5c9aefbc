"""DashboardHUD: Tesla-style live overlay, rendered host-side over sim frames
(port of ``cilrs_tpu/evaluation/hud.py``: host numpy and OpenCV, nothing on
the card; without ``cv2`` the window HUD is off and ``compose`` raises).

Layout parity with the reference's OpenCV HUD (model/autonomous_drive.py:178-355):
960x540 canvas, semi-transparent top/bottom bars, traffic-light circle with STOP
label, large speed readout, color-coded command badge, +/-1 steering bar, GAS/BRK
bars, 3-tier obstacle warning (<18/<12/<6 m), DEST remaining + status line, and
live Safety% / distance / collisions. The sim itself never depends on this —
frames are exported from device and drawn here; `show()` opens a window when a
display exists, `compose()` returns the canvas for video export.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2

    HAS_CV2 = True
except Exception:  # pragma: no cover
    HAS_CV2 = False

W, H = 960, 540
STATUS_NAMES = {
    0: "OK", 1: "RED LIGHT", 2: "YELLOW", 3: "BRAKE", 4: "OVERTAKE-L",
    5: "OVERTAKE-R", 6: "REVERSE", 7: "UNSTICK", 8: "RECOVERY", 9: "TELEPORT",
}
CMD_NAMES = {0: "FOLLOW", 1: "LEFT", 2: "RIGHT", 3: "STRAIGHT"}
CMD_COLORS = {0: (200, 200, 200), 1: (80, 170, 255), 2: (255, 170, 80), 3: (120, 255, 120)}
TL_COLORS = {0: (80, 220, 80), 1: (60, 210, 240), 2: (60, 60, 240), 3: (120, 120, 120)}


class DashboardHUD:
    def __init__(self, window_name: str = "CILRS Dashboard"):
        self.window_name = window_name
        self._window = False

    def compose(
        self,
        frame01: np.ndarray,  # [h, w, 3] float in [0,1] (RGB)
        speed_kmh: float,
        command: int,
        steer: float,
        throttle: float,
        brake: float,
        tl_state: int,
        obstacle_dist: float,
        dest_remaining_m: float,
        status: int | str,
        safety_pct: float,
        distance_m: float,
        collisions: int,
        weather: str = "clear",
    ) -> np.ndarray:
        """Returns the BGR uint8 canvas [540, 960, 3]."""
        if not HAS_CV2:
            raise RuntimeError("cv2 unavailable; HUD disabled")
        if frame01.dtype == np.uint8:
            img = frame01
        else:
            img = (np.clip(frame01, 0, 1) * 255).astype(np.uint8)
        canvas = cv2.resize(img[:, :, ::-1], (W, H), interpolation=cv2.INTER_NEAREST)

        # Semi-transparent bars (reference :200-208).
        overlay = canvas.copy()
        cv2.rectangle(overlay, (0, 0), (W, 70), (20, 20, 20), -1)
        cv2.rectangle(overlay, (0, H - 110), (W, H), (20, 20, 20), -1)
        canvas = cv2.addWeighted(overlay, 0.55, canvas, 0.45, 0)

        # Traffic light indicator (:219-232).
        tl = int(tl_state)
        cv2.circle(canvas, (40, 35), 16, TL_COLORS.get(tl, (120,) * 3), -1)
        if tl == 2:
            cv2.putText(canvas, "STOP", (64, 42), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                        (60, 60, 240), 2)

        # Speed readout (:234-239).
        cv2.putText(canvas, f"{speed_kmh:5.1f}", (W // 2 - 70, 48),
                    cv2.FONT_HERSHEY_SIMPLEX, 1.5, (255, 255, 255), 3)
        cv2.putText(canvas, "km/h", (W // 2 + 60, 48), cv2.FONT_HERSHEY_SIMPLEX,
                    0.6, (180, 180, 180), 1)

        # Command badge (:241-256).
        cmd = int(command)
        cv2.rectangle(canvas, (W - 210, 12), (W - 20, 58), CMD_COLORS.get(cmd, (200,) * 3), 2)
        cv2.putText(canvas, CMD_NAMES.get(cmd, "?"), (W - 195, 45),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.9, CMD_COLORS.get(cmd, (200,) * 3), 2)
        cv2.putText(canvas, weather, (W - 210, 90), cv2.FONT_HERSHEY_SIMPLEX,
                    0.55, (170, 170, 170), 1)

        # Steering bar +/-1 (:258-287).
        bx, by, bw = 60, H - 80, 300
        cv2.rectangle(canvas, (bx, by), (bx + bw, by + 14), (70, 70, 70), -1)
        cv2.line(canvas, (bx + bw // 2, by - 4), (bx + bw // 2, by + 18), (160, 160, 160), 1)
        sx = int(bx + bw / 2 + np.clip(steer, -1, 1) * bw / 2)
        cv2.circle(canvas, (sx, by + 7), 9, (255, 255, 255), -1)
        cv2.putText(canvas, "STEER", (bx, by - 10), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (180, 180, 180), 1)

        # GAS / BRK bars (:289-307).
        gx = bx + bw + 60
        for label, val, color, off in (("GAS", throttle, (80, 220, 80), 0),
                                       ("BRK", brake, (60, 60, 240), 80)):
            cv2.putText(canvas, label, (gx + off, by - 10), cv2.FONT_HERSHEY_SIMPLEX,
                        0.5, (180, 180, 180), 1)
            cv2.rectangle(canvas, (gx + off, by), (gx + off + 50, by + 14), (70, 70, 70), -1)
            cv2.rectangle(canvas, (gx + off, by),
                          (gx + off + int(50 * np.clip(val, 0, 1)), by + 14), color, -1)

        # Obstacle warning, 3 tiers (:309-325).
        od = float(obstacle_dist)
        if od < 18.0:
            if od < 6.0:
                warn, color = "!! OBSTACLE !!", (60, 60, 240)
            elif od < 12.0:
                warn, color = "! OBSTACLE !", (60, 160, 240)
            else:
                warn, color = "OBSTACLE", (60, 210, 240)
            cv2.putText(canvas, f"{warn} {od:.1f}m", (W // 2 - 140, H - 130),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.9, color, 2)

        # DEST + status (:327-335).
        st = STATUS_NAMES.get(status, str(status)) if not isinstance(status, str) else status
        cv2.putText(canvas, f"DEST {dest_remaining_m:6.0f} m   [{st}]",
                    (gx + 170, by + 10), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (230, 230, 230), 1)

        # Live metrics strip (:337-348).
        cv2.putText(canvas,
                    f"Safety {safety_pct:5.1f}%   Dist {distance_m / 1000:5.2f} km   "
                    f"Collisions {int(collisions)}",
                    (60, H - 30), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (200, 200, 200), 1)
        return canvas

    def show(self, canvas: np.ndarray) -> bool:
        """Display; returns False if the user pressed ESC (reference :350-352)."""
        if not self._window:
            cv2.namedWindow(self.window_name, cv2.WINDOW_AUTOSIZE)
            self._window = True
        cv2.imshow(self.window_name, canvas)
        return (cv2.waitKey(1) & 0xFF) != 27

    def close(self):
        if self._window and HAS_CV2:
            cv2.destroyWindow(self.window_name)
            self._window = False
