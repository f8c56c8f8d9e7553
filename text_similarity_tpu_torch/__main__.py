"""``python -m text_similarity_tpu_torch <command>``: the port's CLI."""

from .cli.main import main

if __name__ == "__main__":
    main()
