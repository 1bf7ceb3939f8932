"""``frames_without_pose``: frames handed over in the window that never got
a pose back, of those the sensor delivered a view in (the reference, the
ground truth, has a pose for every frame)."""

NUMBERS = ("frames_without_pose",)
CAPTURES = {}


def readings(calls, ctx, control):
    if control:
        return {"frames_without_pose": 0.0}
    n = sum(1 for s in ctx.sessions for c in s.hand if c not in s.age and not s.blanked(c))
    return {"frames_without_pose": float(n)}
