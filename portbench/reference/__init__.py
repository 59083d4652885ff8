"""The benchmark's plain reference of one closed-loop MPPI step.

Plain PyTorch and NumPy, in any dtype (float64 for the comparison that
decides ``correct``, bfloat16 for its control), batched over scenarios.
It imports nothing of the program under test: each piece is a frozen copy
of the port's plain code, and its header names the file and the commit it
was copied from.

* :mod:`.philox` — the Philox4x32-10 noise stream keyed (seed, step);
* :mod:`.arm` — the arm's semi-implicit Euler step and its kinematics;
* :mod:`.mppi` — the waypoint advance, the rollouts and their cost, the
  softmax, Σwε, the reflected median, the control update and shift, the
  plant and the record row.
"""
