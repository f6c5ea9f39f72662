"""The ported subcommands."""
