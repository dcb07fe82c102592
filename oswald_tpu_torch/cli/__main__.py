import sys

from oswald_tpu_torch.cli.main import main

# guarded: the ranks --devices starts are spawned processes, which import
# this module again under another name
if __name__ == "__main__":
    sys.exit(main())
