"""The first parallel ``torch.sqrt`` of a process, after ``import repro_torch``.

PyTorch's CPU build here (torch 2.13.0+cpu, oneAPI MKL 2024.2) can give
the first ``torch.sqrt`` of a process that several OpenMP threads run at once
one thread's share of the elements at about 12 bits.  ``repro_torch``'s
import makes one serial call first, which keeps the parallel calls exact.
The fault shows in a fresh process only, at its first parallel sqrt, in a few
processes of a hundred, so the test runs many fresh interpreters and holds
every first call bitwise equal to a second one.
"""
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PROCESSES, AT_ONCE = 32, 4

CODE = textwrap.dedent(f"""
    import sys
    sys.path.insert(0, {str(SRC)!r})
    import repro_torch  # noqa: F401
    import torch
    torch.set_num_threads(8)
    warm = torch.ones(1 << 22)
    for _ in range(3):
        warm = warm + 1.0  # starts the OpenMP threads, no sqrt
    x = torch.full((25445,), 2.0)  # gcn's first ms_local at n = 3000: 13 chunks of 2048
    first, second = torch.sqrt(x), torch.sqrt(x)
    print(int((first != second).sum()), float(first.min()))
""")


def _run(_):
    out = subprocess.run([sys.executable, "-c", CODE], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_first_parallel_sqrt_of_a_process_is_exact_after_import():
    with ThreadPoolExecutor(AT_ONCE) as pool:
        results = list(pool.map(_run, range(PROCESSES)))
    bad = [r for r in results if r[0] != "0"]
    assert not bad, f"{len(bad)} of {PROCESSES} processes: (wrong elements, min) {bad}"
    assert all(float(r[1]) == 1.4142135381698608 for r in results)
