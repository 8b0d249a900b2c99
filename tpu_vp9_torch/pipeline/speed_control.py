"""Speed control: dynamic preset switching to hold real-time encode.

Analogue of ``eb_vp9_SpeedBufferControl``
(``EbResourceCoordinationProcess.c:101``) + the ``sc_frame_out``
accounting in ``EbPacketizationProcess.c:488-493``: the encoder tracks
its achieved frame rate against the injected (target) frame rate and
moves the active preset between the configured quality preset and the
fastest preset to keep a virtual output buffer from underflowing.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SpeedControl:
    target_fps: float
    base_mode: int        # quality floor: the user-configured preset
    max_mode: int = 9     # speed ceiling
    check_every: int = 8  # frames between decisions (hysteresis)

    mode: int = -1
    frames: int = 0
    seconds: float = 0.0
    _since_check: int = 0

    def __post_init__(self) -> None:
        if self.mode < 0:
            self.mode = self.base_mode

    def report(self, n_frames: int, seconds: float):
        """Account ``n_frames`` encoded in ``seconds``; returns the new
        preset if it changed, else None."""
        if n_frames <= 0:
            return None
        self.frames += n_frames
        self.seconds += seconds
        self._since_check += n_frames
        if self._since_check < self.check_every or self.seconds <= 0:
            return None
        self._since_check = 0
        achieved = self.frames / self.seconds
        # decay the history so the controller tracks recent throughput
        self.frames *= 0.5
        self.seconds *= 0.5
        old = self.mode
        if achieved < 0.95 * self.target_fps and self.mode < self.max_mode:
            # falling behind: step toward the speed ceiling (the
            # reference moves in single encMode steps per window)
            self.mode += 1
        elif achieved > 1.25 * self.target_fps and self.mode > self.base_mode:
            # comfortably ahead: claw back quality
            self.mode -= 1
        return self.mode if self.mode != old else None
