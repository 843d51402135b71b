"""Runtime checks the port's host modules share (lockcheck.make_lock)."""
