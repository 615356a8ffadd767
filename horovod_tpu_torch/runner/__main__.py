"""``python -m horovod_tpu_torch.runner`` is ``hvdrun``.  The reference's
``fleet`` subcommand (``hvdfleet``) is not ported yet: it fails with an
error and a non-zero exit, and runs nothing in its place."""
import sys

FLEET_NOT_PORTED = (
    "hvdrun: the 'fleet' subcommand (hvdfleet, horovod_tpu/runner/"
    "fleet.py) is not ported to horovod_tpu_torch yet; nothing was run")


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "fleet":
        print(FLEET_NOT_PORTED, file=sys.stderr, flush=True)
        return 2
    from horovod_tpu_torch.runner.run import main as run_main
    return run_main()


sys.exit(main())
