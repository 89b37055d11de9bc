"""PyTorch port, distributed: the launcher.  ``_worker_env`` and the CLI
of ``python -m paddle_tpu_torch.distributed.launch`` against the JAX
package's launcher (equal apart from the device key, FLAGS_selected_gpus
for FLAGS_selected_tpus); then three launches of two stdlib-only worker
scripts, held to the JAX launcher's own assertions
(tests/test_launch.py): the env contract and the worker logs, failure
propagation, an elastic restart.  Each launch runs under ``timeout=`` with
OMP_NUM_THREADS=1."""
import importlib
import os
import subprocess
import sys
import textwrap

import pytest

from _torch_threads import torch_threads  # noqa: F401

# the packages export the function main under the module's name
jlaunch = importlib.import_module("paddle_tpu.distributed.launch.main")
plaunch = importlib.import_module("paddle_tpu_torch.distributed.launch.main")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 120


def _run_launch(tmp_path, script_body, extra_args=(), nproc=2):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(script_body))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc),
           "--log_dir", str(tmp_path / "log"), *extra_args, str(script)]
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S, cwd=str(tmp_path))


WORKER_ENV_ARGS = [
    (0, 0, 1, ["127.0.0.1:6170"], "127.0.0.1:6170", 1, 0, None),
    (1, 1, 2, ["127.0.0.1:1", "127.0.0.1:2"], "127.0.0.1:1", 1, 0, None),
    (1, 3, 4, ["10.0.0.1:7", "10.0.0.1:8", "10.0.0.2:7", "10.0.0.2:8"],
     "10.0.0.1:9000", 2, 1, ["4", "5"]),
]


@pytest.mark.parametrize("args", WORKER_ENV_ARGS)
def test_worker_env_matches_the_reference_but_the_device_key(args):
    want = jlaunch._worker_env(*args)
    got = plaunch._worker_env(*args)
    assert got.pop("FLAGS_selected_gpus") == want.pop("FLAGS_selected_tpus")
    assert got == want


@pytest.mark.parametrize("argv", [
    ["train.py"],
    ["--nproc_per_node", "4", "--log_dir", "L", "train.py", "--lr", "1"],
    ["--master", "10.0.0.1:9000", "--nnodes", "2:4", "--rank", "1",
     "--devices", "0,1", "--elastic_level", "1", "--max_restart", "5",
     "--job_id", "j", "train.py"],
])
def test_cli_matches_the_reference(argv):
    assert vars(plaunch._parse_args(argv)) == vars(jlaunch._parse_args(argv))


def test_auto_tuner_is_refused_naming_its_item(tmp_path):
    with pytest.raises(NotImplementedError, match="14b"):
        plaunch.launch(["--auto_tuner_json", str(tmp_path / "t.json"),
                        "--log_dir", str(tmp_path / "log"),
                        str(tmp_path / "train.py")])


def test_launch_sets_env_contract_and_writes_worker_logs(tmp_path):
    r = _run_launch(tmp_path, """
        import os
        rank = os.environ["PADDLE_TRAINER_ID"]
        n = os.environ["PADDLE_TRAINERS_NUM"]
        eps = os.environ["PADDLE_TRAINER_ENDPOINTS"].split(",")
        assert len(eps) == int(n)
        assert os.environ["PADDLE_CURRENT_ENDPOINT"] == eps[int(rank)]
        assert os.environ["PADDLE_MASTER"]
        assert os.environ["FLAGS_selected_gpus"] == \\
            os.environ["PADDLE_LOCAL_RANK"] == rank
        with open(f"done_{rank}", "w") as f:
            f.write(os.environ["PADDLE_CURRENT_ENDPOINT"])
        print("hello from rank", rank)
    """)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "done_0").exists() and (tmp_path / "done_1").exists()
    # distinct endpoints per rank
    assert (tmp_path / "done_0").read_text() != \
        (tmp_path / "done_1").read_text()
    for rank in (0, 1):
        log = (tmp_path / "log" / f"workerlog.{rank}").read_text()
        assert f"hello from rank {rank}" in log


def test_launch_propagates_failure(tmp_path):
    r = _run_launch(tmp_path, """
        import os, sys
        sys.exit(7 if os.environ["PADDLE_TRAINER_ID"] == "1" else 0)
    """)
    assert r.returncode == 7


def test_launch_elastic_restart(tmp_path):
    """First attempt fails; the relaunch (elastic restart) succeeds."""
    r = _run_launch(tmp_path, """
        import os, sys
        marker = "attempted_" + os.environ["PADDLE_TRAINER_ID"]
        if not os.path.exists(marker):
            open(marker, "w").close()
            sys.exit(1)   # fail the first attempt
        open("ok_" + os.environ["PADDLE_TRAINER_ID"], "w").close()
    """, extra_args=("--elastic_level", "1", "--max_restart", "2"))
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "ok_0").exists() and (tmp_path / "ok_1").exists()
    assert "restart 1/2" in r.stderr
