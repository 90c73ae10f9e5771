"""CLI: flag surface and CSV output contract parity."""

import numpy as np
import pytest

from lam_tpu import cli
from lam_tpu import generate as gen
from lam_tpu import io as lio


def test_gen_mode_csv_contract(capsys):
    rc = cli.main(["-s", "200", "-i", "15", "-o", "/tmp/lam_cli_sol.bin"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    fields = line.split(",")
    # N,procs,threads,load_s,avg_gemv_s,avg_iter_s,num_iter,err,total_cg_s
    assert len(fields) == 9
    assert int(fields[0]) == 200
    # the reference CSV records the loop-exit value cap+1 for
    # unconverged runs (BEST_RESULTS:173-236: 16 for -i 15)
    assert int(fields[6]) == 16
    assert float(fields[7]) > 1e-9       # and not converged
    assert float(fields[8]) >= 0


def test_file_mode_solves_system(tmp_path, capsys):
    a = gen.random_spd_matrix(64, seed=1)
    b = gen.random_rhs(64, seed=11)
    lio.write_matrix(tmp_path / "m.bin", a)
    lio.write_matrix(tmp_path / "r.bin", b)
    sol = tmp_path / "s.bin"
    rc = cli.main(["-A", str(tmp_path / "m.bin"), "-b",
                   str(tmp_path / "r.bin"), "-o", str(sol),
                   "-i", "1000", "-e", "1e-9"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    fields = out.split(",")
    assert int(fields[0]) == 64
    assert float(fields[7]) < 1e-9       # converged
    x = lio.read_vector(sol)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


def test_verbose_mode(tmp_path, capsys):
    rc = cli.main(["-s", "100", "-i", "5", "-v",
                   "-o", str(tmp_path / "s.bin")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Did not converge in 5 iterations" in out
    assert "Finished successfully" in out


def test_mutually_exclusive_modes(capsys):
    rc = cli.main(["-s", "10", "-A", "x.bin"])
    assert rc == 1


def test_help(capsys):
    rc = cli.main(["-h"])
    assert rc == 0
    assert "Usage:" in capsys.readouterr().out


def test_spd_gen_tool(tmp_path, capsys):
    from lam_tpu.tools import spd_gen
    m = tmp_path / "m.bin"
    r = tmp_path / "r.bin"
    rc = spd_gen.main(["48", str(m), str(r), "7"])
    assert rc == 0
    a = lio.read_matrix(m)
    b = lio.read_vector(r)
    assert a.shape == (48, 48) and b.shape == (48,)
    w = np.linalg.eigvalsh(a)
    assert w.min() > 0  # SPD


def test_graft_entry_single_chip():
    import jax

    import __graft_entry__ as ge
    fn, args = ge.entry()
    x = jax.jit(fn)(*args)
    jax.block_until_ready(x)
    assert np.all(np.isfinite(np.asarray(x)))


def test_graft_entry_multichip():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_cli_checkpoint_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    sol = str(tmp_path / "s.bin")
    # run capped at 20 iterations with checkpointing
    rc = cli.main(["-s", "300", "-i", "20", "-o", sol,
                   "--checkpoint", ck, "--checkpoint-every", "10"])
    assert rc == 0
    first = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert int(first[6]) == 21   # unconverged CSV = cap+1
    # resume and give it room to converge further
    rc = cli.main(["-s", "300", "-i", "100", "-o", sol,
                   "--checkpoint", ck, "--resume"])
    assert rc == 0
    second = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert float(second[7]) < float(first[7])  # residual decreased


def test_cli_comm_ring_and_symm_engine(capsys):
    # ring comm through the sharded backend on the virtual mesh
    from lam_tpu.cli import main
    assert main(["-s", "96", "-i", "10", "--backend", "sharded",
                 "--devices", "4", "--comm", "ring",
                 "--precision", "f64"]) == 0
    row = capsys.readouterr().out.strip().split(",")
    assert row[0] == "96" and row[1] == "4"
    # the triangle-walk kernel end-to-end (interpret mode): precision
    # ir on packed storage routes the inner loop through the kernel on
    # the hi plane
    assert main(["-s", "96", "-i", "10", "--backend", "local",
                 "--engine", "pallas_symm_packed", "--precision",
                 "ir"]) == 0
    row = capsys.readouterr().out.strip().split(",")
    assert row[0] == "96" and int(row[6]) == 11


def test_cli_sharded2d_backend(capsys):
    from lam_tpu.cli import main
    assert main(["-s", "96", "-i", "10", "--backend", "sharded2d",
                 "--devices", "4", "--precision", "f64"]) == 0
    row = capsys.readouterr().out.strip().split(",")
    assert row[0] == "96" and int(row[6]) == 11


def test_cli_sharded2d_procs_column_counts_used_devices(capsys):
    # 8 visible devices -> a 2x2 grid uses 4; the procs column must say 4
    # (reference CSV legend: procs = ranks that actually computed,
    # test_CG_CPU_MPI_OMP.cpp:201-204)
    from lam_tpu.cli import main
    assert main(["-s", "96", "-i", "5", "--backend", "sharded2d",
                 "--devices", "8", "--precision", "f64"]) == 0
    row = capsys.readouterr().out.strip().split(",")
    assert row[1] == "4"


def test_cli_positional_form(tmp_path, capsys):
    """Legacy positional drivers: matrix rhs sol iters err
    (test_CG_CPU_OMP.cpp:17-27, defaults -i 1000)."""
    a = gen.random_spd_matrix(64, seed=3)
    b = gen.random_rhs(64, seed=13)
    m, r, s = (str(tmp_path / f) for f in ("m.bin", "r.bin", "s.bin"))
    lio.write_matrix(m, a)
    lio.write_matrix(r, b)
    rc = cli.main([m, r, s, "500", "1e-7"])
    assert rc == 0
    fields = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert int(fields[0]) == 64
    assert float(fields[7]) < 1e-7
    x = lio.read_vector(s)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-6
    # iters slot: a 2-iteration cap must stop the solve at 2
    # (the CSV records the reference's loop-exit value, cap+1)
    rc = cli.main([m, r, s, "2"])
    assert rc == 0
    fields = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert int(fields[6]) == 3


def test_cli_init_col(capsys, tmp_path):
    """--init-col inserts the nccl_init_s slot after load_s
    (ConjugateGradient_MultiGPUS_CUDA_NCCL.cu:332-334)."""
    rc = cli.main(["-s", "100", "-i", "5", "--init-col",
                   "-o", str(tmp_path / "s.bin")])
    assert rc == 0
    fields = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert len(fields) == 10          # one extra column
    assert float(fields[4]) >= 0      # init_s = warmup/compile seconds
    assert int(fields[7]) == 6        # num_iter (cap+1) shifted right


def test_cli_ir_checkpoint_runs(tmp_path, capsys):
    """Round 3: --precision ir composes with --checkpoint (per-cycle
    persistence, lam_tpu/solver/checkpoint.py cg_solve_ir_resumable)."""
    ck = str(tmp_path / "ck")
    rc = cli.main(["-s", "200", "--precision", "ir", "-e", "1e-9",
                   "--checkpoint", ck,
                   "-o", str(tmp_path / "sol.bin")])
    assert rc == 0
    row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert float(row[7]) < 1e-9          # converged rel residual
    import os
    assert os.path.exists(os.path.join(ck, "ir_state.json"))
    # resume from the converged checkpoint: exits immediately, same x
    rc = cli.main(["-s", "200", "--precision", "ir", "-e", "1e-9",
                   "--checkpoint", ck, "--resume",
                   "-o", str(tmp_path / "sol2.bin")])
    assert rc == 0
    capsys.readouterr()
    x1 = lio.read_vector(str(tmp_path / "sol.bin"))
    x2 = lio.read_vector(str(tmp_path / "sol2.bin"))
    np.testing.assert_array_equal(x1, x2)


def test_cli_preconditioner_checkpoint_composes(tmp_path, capsys):
    """--preconditioner jacobi composes with --checkpoint (round 3
    closes the last rejected combination: the resumable driver gained
    PCG plumbing; later in round 3 the ir driver gained it too)."""
    ck = str(tmp_path / "ck")
    rc = cli.main(["-s", "200", "--preconditioner", "jacobi",
                   "--precision", "f64", "-e", "1e-9", "-i", "2000",
                   "--checkpoint", ck, "--checkpoint-every", "50",
                   "-o", str(tmp_path / "sol.bin")])
    assert rc == 0
    row = capsys.readouterr().out.strip().split(",")
    assert int(row[6]) < 2000 and float(row[7]) < 1e-9  # converged
    import json
    import os
    with open(os.path.join(ck, "state.json")) as f:
        assert json.load(f)["kind"] == "pcg"
    # resuming the PCG checkpoint as plain CG must be refused
    rc = cli.main(["-s", "200", "--precision", "f64",
                   "--checkpoint", ck, "--resume",
                   "-o", str(tmp_path / "sol2.bin")])
    assert rc == 1
    capsys.readouterr()
    # ir + preconditioner + checkpoint: composes; the sidecar records
    # the preconditioner so a mismatched resume is refused
    ck2 = str(tmp_path / "ck2")
    rc = cli.main(["-s", "200", "--preconditioner", "jacobi",
                   "--precision", "ir", "-e", "1e-9", "-i", "5000",
                   "--checkpoint", ck2,
                   "-o", str(tmp_path / "sol3.bin")])
    assert rc == 0
    row = capsys.readouterr().out.strip().split(",")
    assert float(row[7]) < 1e-9
    with open(os.path.join(ck2, "ir_state.json")) as f:
        assert json.load(f)["preconditioner"] == "jacobi"
    rc = cli.main(["-s", "200", "--precision", "ir",
                   "--checkpoint", ck2, "--resume",
                   "-o", str(tmp_path / "sol4.bin")])
    assert rc == 1
    assert "preconditioner" in capsys.readouterr().err


def test_cli_jacobi_preconditioner(tmp_path, capsys):
    """--preconditioner jacobi end-to-end, local and sharded."""
    a = gen.random_spd_matrix(96, seed=6)
    s = np.exp(np.linspace(0, 4, 96))
    a = a * np.outer(s, s)          # bad scaling: jacobi should win
    b = gen.random_rhs(96, seed=16)
    m, r, o = (str(tmp_path / f) for f in ("m.bin", "r.bin", "s.bin"))
    lio.write_matrix(m, a)
    lio.write_matrix(r, b)
    base = ["-A", m, "-b", r, "-o", o, "-i", "3000", "--precision", "f64"]
    assert cli.main(base) == 0
    plain = capsys.readouterr().out.strip().split(",")
    assert cli.main(base + ["--preconditioner", "jacobi"]) == 0
    pcg = capsys.readouterr().out.strip().split(",")
    assert float(pcg[7]) < 1e-9
    assert int(pcg[6]) < int(plain[6])   # fewer iterations than plain CG
    x = lio.read_vector(o)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8
    assert cli.main(base + ["--preconditioner", "jacobi", "--backend",
                            "sharded", "--devices", "4"]) == 0
    srow = capsys.readouterr().out.strip().split(",")
    assert float(srow[7]) < 1e-9
    # ir + preconditioner composes (round 3: the inner f32 loop is
    # Jacobi-scaled; on this badly-scaled system plain ir stalls at
    # the f32 floor while the preconditioned inner converges)
    assert cli.main(base + ["--preconditioner", "jacobi",
                            "--precision", "ir"]) == 0
    irrow = capsys.readouterr().out.strip().split(",")
    assert float(irrow[7]) < 1e-9
    x = lio.read_vector(o)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


# -- clean error surface (round 3; reference prints one line and exits:
# ConjugateGradient_CPU_MPI_OMP.hpp:325-329) ---------------------------------


def _err_run(args, capsys):
    rc = cli.main(args)
    err = capsys.readouterr().err
    return rc, err


def test_cli_missing_matrix_file(capsys):
    rc, err = _err_run(["-A", "/nonexistent_lam.bin", "-b", "x.bin"],
                       capsys)
    assert rc == 1
    assert "lam-cg:" in err and "Traceback" not in err


def test_cli_corrupt_header(tmp_path, capsys):
    p = tmp_path / "corrupt.bin"
    p.write_bytes(b"short")
    rc, err = _err_run(["-A", str(p)], capsys)
    assert rc == 1
    assert "not a LAM binary file" in err


def test_cli_truncated_payload(tmp_path, capsys):
    good = tmp_path / "trunc.bin"
    lio.write_matrix(str(good), np.eye(16))
    data = good.read_bytes()
    good.write_bytes(data[:len(data) // 2])
    rc, err = _err_run(["-A", str(good)], capsys)
    assert rc == 1
    assert "truncated" in err


def test_cli_non_square_matrix(tmp_path, capsys):
    p = tmp_path / "rect.bin"
    lio.write_matrix(str(p), np.ones((4, 6)))
    rc, err = _err_run(["-A", str(p), "-b", str(p)], capsys)
    assert rc == 1
    assert "square" in err


def test_cli_rhs_size_mismatch(tmp_path, capsys):
    m = tmp_path / "m.bin"
    r = tmp_path / "r.bin"
    lio.write_matrix(str(m), np.eye(8) * 2)
    lio.write_matrix(str(r), np.ones(5))
    rc, err = _err_run(["-A", str(m), "-b", str(r)], capsys)
    assert rc == 1
    assert "right hand side" in err


def test_heat_cli_bad_args(capsys):
    from lam_tpu.apps import heat_cli
    rc = heat_cli.main(["-3", "10", "/tmp/heat_out.bin"])
    err = capsys.readouterr().err
    assert rc == 1
    # reference-parity message (heat_equation.cpp argument validation)
    assert "Wrong argument value" in err and "Traceback" not in err


def test_bmp_cli_missing_input(tmp_path, capsys):
    from lam_tpu.apps import bmp_cli
    rc = bmp_cli.main([str(tmp_path / "nope.bin"),
                       str(tmp_path / "out.bmp")])
    err = capsys.readouterr().err
    assert rc == 1
    assert "lam-heat-to-bmp:" in err


def test_spd_gen_bad_size(capsys):
    from lam_tpu.tools import spd_gen
    rc = spd_gen.main(["-5", "/tmp/m.bin", "/tmp/r.bin"])
    err = capsys.readouterr().err
    assert rc == 1
    assert "Wrong argument value" in err


def test_spd_gen_unwritable_output(tmp_path, capsys):
    # a path THROUGH a regular file fails os.makedirs with
    # NotADirectoryError regardless of privileges (tests run as root)
    from lam_tpu.tools import spd_gen
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    rc = spd_gen.main(["32", str(blocker / "m.bin"),
                       str(tmp_path / "r.bin")])
    err = capsys.readouterr().err
    assert rc == 1
    assert "lam-spd-gen:" in err and "Traceback" not in err


def test_cli_pack_cache_publishes_and_reuses(tmp_path, capsys):
    """--pack-cache (round 3): the first irfq file-mode run publishes
    the packed planes beside the matrix file; the second solves from
    them with an identical CSV row (N, num_iter, err)."""
    import os

    a = gen.random_spd_matrix(64, seed=5)
    b = gen.random_rhs(64, seed=15)
    m = tmp_path / "m.bin"
    lio.write_matrix(m, a)
    lio.write_matrix(tmp_path / "r.bin", b)
    argv = ["-A", str(m), "-b", str(tmp_path / "r.bin"),
            "-o", str(tmp_path / "s.bin"), "-e", "1e-9",
            "--backend", "local", "--precision", "irfq", "--pack-cache"]
    assert cli.main(argv) == 0
    row1 = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert os.path.exists(str(m) + ".fqpack")
    assert cli.main(argv) == 0
    row2 = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    # identical solve (same packed planes): N, num_iter, err all match
    assert row1[0] == row2[0] and row1[6] == row2[6]
    assert row1[7] == row2[7]
    x = lio.read_vector(str(tmp_path / "s.bin"))
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


def test_cli_pack_cache_covers_plane_precisions(tmp_path, capsys):
    """--pack-cache (round 4) also serves the UNQUANTIZED f32/df64
    packed-triangle loads, where the host f64->f32 conversion is the
    load's main cost. Same contract as the irfq test: publish on first
    run, identical CSV row from the cache on the second."""
    import os

    a = gen.random_spd_matrix(64, seed=5)
    b = gen.random_rhs(64, seed=15)
    m = tmp_path / "m.bin"
    lio.write_matrix(m, a)
    lio.write_matrix(tmp_path / "r.bin", b)
    # pure-f32 iterations floor the TRUE residual near f32 eps * kappa;
    # ir refines in df64 so it actually reaches the requested 1e-6
    for precision, ext, true_tol in (("f32", ".f32pack", 2e-4),
                                     ("ir", ".df64pack", 1e-5)):
        argv = ["-A", str(m), "-b", str(tmp_path / "r.bin"),
                "-o", str(tmp_path / "s.bin"), "-e", "1e-6",
                "--backend", "local", "--precision", precision,
                "--engine", "pallas_symm_packed", "--pack-cache"]
        assert cli.main(argv) == 0
        row1 = capsys.readouterr().out.strip().splitlines()[-1].split(",")
        assert os.path.exists(str(m) + ext)
        assert cli.main(argv) == 0
        row2 = capsys.readouterr().out.strip().splitlines()[-1].split(",")
        assert row1[0] == row2[0] and row1[6] == row2[6]
        assert row1[7] == row2[7]
        x = lio.read_vector(str(tmp_path / "s.bin"))
        assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < true_tol


def test_cli_check_symmetric_rejects_asymmetric(tmp_path, capsys):
    """--check-symmetric restores the loud failure for non-symmetric
    input that the file fast paths (which TRUST symmetry, CG's
    contract) deliberately skip (ADVICE r4)."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((32, 32))  # decidedly not symmetric
    b = rng.standard_normal(32)
    lio.write_matrix(tmp_path / "m.bin", a)
    lio.write_matrix(tmp_path / "r.bin", b)
    rc = cli.main(["-A", str(tmp_path / "m.bin"),
                   "-b", str(tmp_path / "r.bin"),
                   "-o", str(tmp_path / "s.bin"), "--check-symmetric"])
    assert rc == 1
    assert "not symmetric" in capsys.readouterr().err
    # a symmetric system passes the check and solves
    s = gen.random_spd_matrix(32, seed=3)
    lio.write_matrix(tmp_path / "m.bin", s)
    rc = cli.main(["-A", str(tmp_path / "m.bin"),
                   "-b", str(tmp_path / "r.bin"),
                   "-o", str(tmp_path / "s.bin"), "--check-symmetric"])
    assert rc == 0
